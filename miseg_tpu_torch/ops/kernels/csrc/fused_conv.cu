// Fused 3x3x3 convolution with normalise-on-read and a statistics epilogue
// (kernel K4), sm_90a.
//
// Replaces the Pallas TPU kernels `_conv_kernel` / `_conv_kernel_plain`
// (miseg_tpu/ops/pallas/fused_conv.py:49-93, called from `_pallas_conv`
// :96-139, public entry `conv3_norm_stats` :215).  For a channel-last
// x [B, Z, Y, X, Cin] and weights w [3, 3, 3, Cin, Cout]:
//     t = round_T(leaky(x * scale[b, ci] + shift[b, ci]))   (each optional)
//     y = round_T(conv3(t))      zero "same" padding OF t, stride 1, no bias
// Halo voxels outside the volume are zero after the transform (the TPU
// kernel multiplies its z-halo by `valid` and pads y/x with zeros after
// `_transform`), which is the unfused path's zero-padded normalised input.
//
// D-halo mode (spatial partitioning, `parallel/spatial.py`): x is
// [B, Z + 2, Y, X, Cin], a rank's Z-plane slab of a volume with one plane
// of each neighbour's around it, and y is [B, Z, Y, X, Cout].  The prologue
// runs on the halo planes too; a halo plane flagged as the volume's own
// zero padding (the first rank's low plane, the last rank's high plane) is
// zero after the prologue, as today's padding is.  Every path addresses x
// through Args::zoff (the planes before the slab's first) and Args::Sx (x's
// voxels a sample) and takes a z neighbour inside [zlo, zhi): [0, Z) for a
// whole volume, one plane further on each side that is not flagged.  The
// planners see the output's geometry; the statistics cover its Z planes.
// The epilogue rounds y to T, stores it, and writes the per-channel
// (mean, M2) of the ROUNDED values of its tile: a 4x4x16 brick on the
// brick path, a 4x4x4 brick or the whole sample on the coarse path, else
// kTile consecutive voxels of one sample (only a sample's last tile is
// short), taken two-pass over the tile held in shared memory.  The partials are laid out [2, B*n_tiles,
// Cout] like K1's pass 1, so K1's fold turns them into the next norm's
// scale/shift.  The TPU kernel's one-pass (sum, sum^2) carried across a
// sequential grid has no counterpart here: blocks run in parallel, and no
// float atomics are used, so a repeated call is bit-identical.
//
// What bounds it on an H100: at the flagship's 96^3 shapes in bf16 the
// convolution does 2*27*Cin*Cout operations per voxel, 110 GFLOP at
// 48->48 and 220 GFLOP at 96->48, against 170 and 255 MB moved: it is
// bound by the tensor cores (0.11 and 0.22 ms at 989 TFLOP/s).  encoder1's
// 1->48 conv (reduction depth 27) and the 3^3 768->768 conv (31.9 MB of
// weights, 0.86 GFLOP) are bound by bytes.  An implicit GEMM gathers each
// input element once per tap, so a design that also transforms it per tap
// does the prologue 27 times per element; staging (dz, dy) bands of x-rows
// cut that to 9, and the transform still cost about as much as the MMAs.
//
// Design.  Implicit GEMM: M = output voxels, N = Cout in blocks, K =
// 27*Cin.  Four paths.  The three tensor-core paths take bf16 with Cin and
// Cout multiples of 4 (or Cin = 1): channels that are no multiple of 16
// (the search space's 12, 24, 36, 72) are padded in shared memory only.
// Cin goes up to a multiple of the chunk KC (the last chunk partly
// padded), Cout to a multiple of 16 with the fewest column blocks; the
// planner weighs the padded MMAs against the work each chunk and each
// column block repeats (pad_cin, pad_cout): 12 -> 16, 24 -> 32, 36 -> 48,
// 72 -> 96.
// The x halo's copies zero-fill the channels >= Cin: rows of 12 or 36
// bf16 channels (24, 72 bytes) are only 8-byte aligned, so they move in
// 8-byte cp.async copies, 16-byte ones where Cin % 8 == 0; the copy width
// is a template parameter, and Cin % 16 == 0 keeps today's copies.  The
// staged prologue columns are 0 past Cin, so a padded channel stays 0
// through leaky(0 * 0 + 0).  The packed weights arrive padded, zero rows
// ci >= Cin and zero columns co >= Cout (the wrapper's cached copy, its
// widths from miseg_fused_conv3_weight_widths).  y and the statistics
// partials keep the real Cout: the epilogue stores and folds only columns
// < Cout, 8 bytes at a time where Cout % 8 != 0.
//   * a volume that 4x4x16 bricks divide (the 96^3 and 48^3 levels):
//     miseg_k4_conv_brick.  A CTA owns
//     one brick (256 voxels) and 16*NF output channels.  Per chunk of KC
//     input channels it copies the brick's 6x6x18 input halo once with
//     cp.async (zero fill outside the volume), transforms it once in shared
//     memory (halo outside the volume stays 0), and all 27 taps read
//     shifted views of it: the 16 voxels of an x-row at tap (kz, ky, kx)
//     are 16 consecutive halo rows, so ldmatrix serves every tap with no
//     further staging.  Each element is transformed 648/256 = 2.5 times
//     (9 with bands, 27 per tap).  The weight slices of 3 taps at a time
//     stream through a 2-stage cp.async ring (9 barriers per chunk, not
//     27); mma.sync m16n8k16 (bf16 in, f32 accumulators), 8 warps of 2
//     x-rows (32 voxels) by 16*NF channels.  At 48->48 and 96->48 (KC =
//     48) a CTA takes 105 KB, two per SM, so one CTA's halo copy and
//     transform overlap the other's MMAs.  The
//     statistics tile is the brick.
//   * the other calls whose volume
//     4x4x4 bricks divide (24^3, 12^3) or whose sample holds at most 256
//     voxels (6^3, 3^3): miseg_k4_conv_coarse, the brick path's scheme
//     on a box tile, the 4x4x4 brick or the whole sample.  A CTA stages
//     the box's input halo once per 32-channel chunk and transforms it
//     once; each lane of an ldmatrix gives its own halo row, so the 16
//     rows of an A fragment are any 16 voxels of the box.  These levels
//     hold few tiles (27 bricks at 12^3, one tile at 6^3 and 3^3) and the
//     6^3 and 3^3 convs are bound by their weights (15.9 and 31.9 MB), so
//     K is split over (channel chunk, kz, ky) units until about one CTA
//     per SM streams a disjoint weight slice.  The splits add up inside
//     the same launch, pairwise up a fixed binary tree: the two CTAs of a
//     pair write their f32 sums (valid rows only) to a workspace and bump
//     an integer arrival counter, and the second to arrive adds the other's
//     sums to its own and goes on; the root runs the epilogue.  No float
//     atomics, and a commutative add per node: a repeated call is
//     bit-identical.
//   * Cin = 1 (encoder1's first conv) on a volume that 4x4x16 bricks
//     divide: miseg_k4_conv_cin1.  The reduction
//     is the 27 taps alone, so the call is bound by its y write (85 MB at
//     96^3 -> 48, 25 us).  A CTA keeps the [32, BN] weight slice (taps
//     zero-padded to K = 32) in registers as B fragments and walks bricks:
//     it copies a brick's 6x6x18 one-channel halo once (zero outside the
//     volume), applies the prologue once in shared memory, gathers the
//     brick's 256 x 32 im2col rows straight into A fragments, and runs two
//     k-steps of mma.sync per fragment; the next brick's halo loads are in
//     flight meanwhile.  Its epilogue is its own, lean on shared memory
//     (see the kernel).  The statistics tile is the brick.
//   * f32 at any width, bf16 with a Cin or Cout that is no multiple of 4
//     (Cin = 1 aside), and bf16 volumes that neither brick divides and
//     that hold more than 256 voxels (none in the flagship or the search
//     space at a ROI that is a multiple of 32): miseg_k4_conv_fma, CUDA
//     cores in f32 FMA (never TF32).  A CTA computes 128 voxels by BN
//     columns, BN the least of 16, 32 and 64 that covers Cout (64 above
//     it), 256 threads of 4 columns by 128*BN/1024 rows; K in chunks of
//     16 with any (tap, channel) split, double-buffered through
//     registers.  Few tiles split K: each split writes its f32 partial
//     sums to a workspace and a second kernel, on the same column block,
//     adds the splits in a fixed order before the same epilogue.  The
//     brick path never splits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using miseg::ldmatrix_x4;
using miseg::ldmatrix_x4_trans;
using miseg::mma_bf16;

constexpr int kTile = 128;      // voxels per tile; only a sample's last is short
constexpr int kThreads = 256;   // CUDA-core path and split-K reduce: 8 warps
constexpr int kFmaKc = 16;     // CUDA-core path: K per step
constexpr int kFmaRowPad = kTile + 4;
constexpr int kMaxSplits = 32;
constexpr int kMinStepsPerSplit = 8;

struct Args {
  const void* x;        // [B, Z, Y, X, cin], T
  const void* w;        // [27, wcin, wcout], T: zero past cin, cout
  const float* scale;   // [B, cin] or null
  const float* shift;   // [B, cin] or null
  float slope;
  int leaky;
  void* y;              // [B, Z, Y, X, cout], T
  float* part;          // [2, n_parts, cout]: (mean, M2) per tile
  float* work;          // [splits, n_parts * tile voxels, wcout] partial sums, or null
  int* counters;        // coarse path: arrival count per (tile, N block), all 0
  int Z, Y, X, cin, cout, n_tiles, splits, nsteps;
  int wcin, wcout;      // the padded widths of w (cin, cout on the CUDA-core path)
  int S;                // voxels per sample of y
  int Sx;               // voxels per sample of x: S, or (Z + 2) * Y * X in D-halo mode
  int zlo, zhi, zoff;   // a z neighbour is read when zlo <= z < zhi, at plane z + zoff of x
  long long n_parts;    // B * n_tiles
  int tz, ty, tx;       // coarse path: the box tile
  int smem_main;        // coarse path: dynamic shared bytes before the columns
  int tree;             // coarse path: counters per (tile, N block), a power of 2 >= splits
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// x * scale + shift, then leaky; two roundings, as the plain version's
// separate multiply and add (no FMA contraction)
__device__ __forceinline__ float prologue(float v, float sc, float sh,
                                          bool affine, bool leaky, float slope) {
  if (affine) v = __fadd_rn(__fmul_rn(v, sc), sh);
  if (leaky && !(v >= 0.0f)) v = __fmul_rn(slope, v);
  return v;
}

// The prologue on 8 bf16 channels c .. c + 7 in shared memory, with the
// sample's columns ssc/ssh staged in shared memory; one rounding to bf16.
__device__ __forceinline__ void transform8(__nv_bfloat16* at, const float* ssc,
                                           const float* ssh, int c, bool affine,
                                           bool leaky, float slope) {
  uint4* p = reinterpret_cast<uint4*>(at);
  uint4 val = *p;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; j += 4) {   // the columns, 16 bytes at a time
    const float4 s4 = affine ? *reinterpret_cast<const float4*>(ssc + c + j)
                             : make_float4(1.f, 1.f, 1.f, 1.f);
    const float4 h4 = affine ? *reinterpret_cast<const float4*>(ssh + c + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[j] = s4.x; sc[j + 1] = s4.y; sc[j + 2] = s4.z; sc[j + 3] = s4.w;
    sh[j] = h4.x; sh[j + 1] = h4.y; sh[j + 2] = h4.z; sh[j + 3] = h4.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    f.x = prologue(f.x, sc[2 * j], sh[2 * j], affine, leaky, slope);
    f.y = prologue(f.y, sc[2 * j + 1], sh[2 * j + 1], affine, leaky, slope);
    h[j] = __floats2bfloat162_rn(f.x, f.y);
  }
  *p = val;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 16 : 0));  // 0: zero-fill
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(s), "l"(src), "r"(fill ? 8 : 0));  // 0: zero-fill
}

// How the tensor-core paths copy 8 channels c .. c + 7 of voxel m (-1:
// outside the volume) of the x halo, by the template parameter HC:
// kWholeChunks, one 16-byte copy where Cin % 16 == 0 and every KC-channel
// chunk is real; 8, one 16-byte copy where Cin % 8 == 0 and the last chunk
// is padded; 4, two 8-byte copies where Cin % 4 == 0 (its rows are only
// 8-byte aligned).  Padded channels, like voxels outside the volume, are
// zero-filled.  A thread copies whole 8-channel groups, the unit the
// transform takes, so it transforms only what its own copies brought.
constexpr int kWholeChunks = 0;

template <int HC>
__device__ __forceinline__ void copy_halo8(__nv_bfloat16* dst, const __nv_bfloat16* x,
                                           int m, int c, int cin) {
  if constexpr (HC == kWholeChunks) {
    cp_async16(dst, m >= 0 ? x + (long long)m * cin + c : x, m >= 0);
  } else if constexpr (HC == 8) {
    const bool in = m >= 0 && c < cin;
    cp_async16(dst, in ? x + (long long)m * cin + c : x, in);
  } else {
#pragma unroll
    for (int h = 0; h < 8; h += 4) {
      const bool in = m >= 0 && c + h < cin;
      cp_async8(dst + h, in ? x + (long long)m * cin + c + h : x, in);
    }
  }
}

// The prologue's columns of sample b in shared memory, 0 from cin up to
// wcin: a padded channel, zero-filled, stays 0 through the transform.
__device__ __forceinline__ void stage_columns(const Args& a, int b, float* ssc, float* ssh,
                                             int threads) {
  for (int c = threadIdx.x; c < a.wcin; c += threads) {
    const bool real = c < a.cin;
    ssc[c] = real ? a.scale[(long long)b * a.cin + c] : 0.0f;
    ssh[c] = real ? a.shift[(long long)b * a.cin + c] : 0.0f;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

struct Tile {
  int b, tile, nvalid;
  long long tile_global;  // b * n_tiles + tile
};

__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile t;
  t.b = blockIdx.x / a.n_tiles;
  t.tile = blockIdx.x % a.n_tiles;
  t.nvalid = min(kTile, a.S - t.tile * kTile);
  t.tile_global = (long long)t.b * a.n_tiles + t.tile;
  return t;
}

// Per tile row: its flat voxel index within x's sample, and bit `tap`
// (tap = kz*9 + ky*3 + kx) set when that neighbour lies inside the volume.
// Rows past the sample's end get no bits.
__device__ __forceinline__ void tile_rows(const Args& a, const Tile& t, int* roff,
                                          unsigned* rmask) {
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    unsigned mask = 0u;
    const int m = t.tile * kTile + r;
    if (r < t.nvalid) {
      const int q = m / a.X, x = m - q * a.X;
      const int y = q % a.Y, z = q / a.Y;
      for (int tap = 0; tap < 27; ++tap) {
        const int zz = z + tap / 9 - 1, yy = y + (tap / 3) % 3 - 1, xx = x + tap % 3 - 1;
        if (zz >= a.zlo && zz < a.zhi && (unsigned)yy < (unsigned)a.Y &&
            (unsigned)xx < (unsigned)a.X)
          mask |= 1u << tap;
      }
    }
    roff[r] = m + a.zoff * a.Y * a.X;   // the voxel's flat index in x
    rmask[r] = mask;
  }
}

// Flat-index offset of a tap's neighbour.
__device__ __forceinline__ int tap_delta(const Args& a, int tap) {
  return ((tap / 9 - 1) * a.Y + (tap / 3) % 3 - 1) * a.X + tap % 3 - 1;
}

// The K steps [begin, end) of this CTA's split.
__device__ __forceinline__ void split_range(const Args& a, int& begin, int& end) {
  const int per = (a.nsteps + a.splits - 1) / a.splits;
  begin = blockIdx.z * per;
  end = min(a.nsteps, begin + per);
}

// V channels a thread: rounds the tile's f32 sums (rows < nvalid, columns
// < ncols) to T in place and stores them to y with one vector store of
// V * sizeof(T) bytes (16 or 32; 8 where Cout % 8 != 0), or one at a time.
template <typename T, int V, typename VoxelOf>
__device__ __forceinline__ void store_rows(const Args& a, const Tile& t, float* Cs, int ldc,
                                           int ncols, int n0, VoxelOf voxel) {
  T* y = static_cast<T*>(a.y);
  const long long row0 = (long long)t.b * a.S;
  const int groups = ncols / V;
  for (int e = threadIdx.x; e < t.nvalid * groups; e += blockDim.x) {
    const int r = e / groups, c = (e - r * groups) * V;
    float* src = Cs + r * ldc + c;
    __align__(16) T v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = from_f32<T>(src[k]);
      src[k] = to_f32(v[k]);
    }
    T* dst = y + (row0 + voxel(r)) * a.cout + n0 + c;
    if constexpr (sizeof(v) % 16 == 0) {
#pragma unroll
      for (int k = 0; k < (int)sizeof(v) / 16; ++k)
        reinterpret_cast<uint4*>(dst)[k] = reinterpret_cast<const uint4*>(v)[k];
    } else if constexpr (sizeof(v) == 8) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) dst[k] = v[k];
    }
  }
}

// Epilogue.  Cs holds the f32 sums of the tile, [tile][ldc]; rows >=
// nvalid and columns >= ncols (a padded Cout's, or past the last block's
// Cout) are ignored; row r is voxel voxel(r) of the sample.  Rounds to T,
// stores y, then takes the per-channel (mean, M2) of the rounded values
// two-pass: a thread per column, over the rows.
template <typename T, typename VoxelOf>
__device__ void epilogue(const Args& a, const Tile& t, float* Cs, int ldc, int ncols,
                         int n0, VoxelOf voxel) {
  if (ncols % 8 == 0 && a.cout % 8 == 0)
    store_rows<T, 8>(a, t, Cs, ldc, ncols, n0, voxel);
  else if (ncols % 4 == 0 && a.cout % 4 == 0)
    store_rows<T, 4>(a, t, Cs, ldc, ncols, n0, voxel);
  else
    store_rows<T, 1>(a, t, Cs, ldc, ncols, n0, voxel);
  __syncthreads();
  // a thread per column, each pass in four interleaved partial sums (a
  // fixed order): neighbouring threads read neighbouring banks, and the
  // chains are a quarter of the tile long
  const int n = t.nvalid, n4 = n & ~3;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const float* col = Cs + c;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < n4; r += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[k] += col[(r + k) * ldc];
    for (int r = n4; r < n; ++r) s[0] += col[r * ldc];
    const float mean = ((s[0] + s[1]) + (s[2] + s[3])) / (float)n;
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < n4; r += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = col[(r + k) * ldc] - mean;
        m[k] = fmaf(d, d, m[k]);
      }
    for (int r = n4; r < n; ++r) {
      const float d = col[r * ldc] - mean;
      m[0] = fmaf(d, d, m[0]);
    }
    a.part[t.tile_global * a.cout + n0 + c] = mean;
    a.part[(a.n_parts + t.tile_global) * a.cout + n0 + c] = (m[0] + m[1]) + (m[2] + m[3]);
  }
}

// The voxel of row r of a tile of kTile consecutive voxels.
struct TileRows {
  int m0;
  __device__ int operator()(int r) const { return m0 + r; }
};

// Row r, column c of this split's slice of the workspace.
__device__ __forceinline__ float* work_at(const Args& a, const Tile& t, int r, int c) {
  return a.work + ((long long)blockIdx.z * a.n_parts * kTile
                   + t.tile_global * kTile + r) * a.cout + c;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, by brick: wcin % KC == 0, wcout % (16 * NF) ==
// 0 (the padded widths; HC says how the halo is copied), and the volume
// divides into 4 x 4 x 16 bricks (z, y, x).  A CTA owns one
// brick (256 output voxels) and BN output channels.  Per KC-channel chunk
// it copies the brick's input halo, 6 x 6 x 18 voxels, once (cp.async,
// zero fill outside the volume), transforms it once in shared memory (the
// halo outside the volume stays 0), and then all 27 taps read shifted
// views of it: at tap (kz, ky, kx) the 16 voxels of an x-row of the brick
// are 16 consecutive halo rows, so ldmatrix serves every tap with no
// further staging.  The weight slices of kBrickTaps taps at a time stream
// through a kBrickStages-deep cp.async ring.  Each warp multiplies 2
// x-rows (32 voxels) by BN channels with mma.sync m16n8k16.

constexpr int kBrickZ = 4, kBrickY = 4, kBrickX = 16;
constexpr int kBrick = kBrickZ * kBrickY * kBrickX;              // 256 voxels
constexpr int kHaloZ = kBrickZ + 2, kHaloY = kBrickY + 2, kHaloX = kBrickX + 2;
constexpr int kHalo = kHaloZ * kHaloY * kHaloX;                  // 648 voxels
constexpr int kBrickThreads = kBrick / 32 * 32;                  // a warp per 32 voxels
constexpr int kBrickTaps = 3;      // taps per weight-ring stage (divides 27)
constexpr int kBrickStages = 2;    // weight-ring stages

template <int NF, int KC>
struct BrickShape {
  static constexpr int BN = 16 * NF, BNP = BN + 8, KCP = KC + 8, LDC = BN + 4;
  // 16-byte row padding: 8 consecutive rows of ldmatrix hit distinct banks
  static constexpr size_t HALO = (size_t)kHalo * KCP * sizeof(__nv_bfloat16);
  static constexpr int STAGE = kBrickTaps * KC * BNP;   // bf16 per ring stage
  static constexpr size_t RING = (size_t)kBrickStages * STAGE * sizeof(__nv_bfloat16);
  static constexpr size_t CS = (size_t)kBrick * LDC * sizeof(float);
  static constexpr size_t BYTES = HALO + RING > CS ? HALO + RING : CS;  // + 2*wcin floats
};

// The voxel of row r of a brick: rows run x fastest, then y, then z.
struct BrickRows {
  int z0, y0, x0, Y, X;
  __device__ int operator()(int r) const {
    const int q = r / kBrickX;
    return ((z0 + q / kBrickY) * Y + y0 + q % kBrickY) * X + x0 + r % kBrickX;
  }
};

// halo voxel hv (x fastest) of the brick at `rows` -> its flat voxel index
// in x, or -1 outside the volume (or on a flagged halo plane)
__device__ __forceinline__ int brick_halo_voxel(const Args& a, const BrickRows& rows, int hv) {
  const int hx = hv % kHaloX, hy = hv / kHaloX % kHaloY, hz = hv / (kHaloX * kHaloY);
  const int zz = rows.z0 - 1 + hz, yy = rows.y0 - 1 + hy, xx = rows.x0 - 1 + hx;
  const bool in = zz >= a.zlo && zz < a.zhi && (unsigned)yy < (unsigned)a.Y &&
                  (unsigned)xx < (unsigned)a.X;
  return in ? ((zz + a.zoff) * a.Y + yy) * a.X + xx : -1;
}

template <int NF, int KC, int HC>
__global__ void __launch_bounds__(kBrickThreads, 2)
miseg_k4_conv_brick(Args a) {
  using Sh = BrickShape<NF, KC>;
  constexpr int BN = Sh::BN, BNP = Sh::BNP, KCP = Sh::KCP;
  constexpr int SEGS = KC / 8, H_VECS = kHalo * SEGS;
  constexpr int B_SEGS = BN / 8, B_VECS = kBrickTaps * KC * B_SEGS;
  constexpr int NSTAGES = 27 / kBrickTaps, S = kBrickStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);    // [kHalo][KCP]
  __nv_bfloat16* Ws = Hs + kHalo * KCP;                           // [S][taps][KC][BNP]
  float* ssc = reinterpret_cast<float*>(smem + Sh::BYTES);
  float* ssh = ssc + a.wcin;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Tile t;
  t.b = blockIdx.x / a.n_tiles;
  t.tile = blockIdx.x % a.n_tiles;
  t.nvalid = kBrick;
  t.tile_global = blockIdx.x;
  const int nbx = a.X / kBrickX, nby = a.Y / kBrickY;
  const BrickRows rows{t.tile / (nbx * nby) * kBrickZ, t.tile / nbx % nby * kBrickY,
                       t.tile % nbx * kBrickX, a.Y, a.X};
  const int n0 = blockIdx.y * BN;
  const int cin = a.cin, wcin = a.wcin, wcout = a.wcout;
  const bool affine = a.scale != nullptr, leaky = a.leaky != 0;
  const bool transform = affine || leaky;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) + (long long)t.b * a.Sx * cin;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  if (affine) stage_columns(a, t.b, ssc, ssh, kBrickThreads);

  auto issue_halo = [&](int c0) {
    for (int v = tid; v < H_VECS; v += kBrickThreads) {
      const int hv = v / SEGS, seg = v - hv * SEGS;
      copy_halo8<HC>(Hs + hv * KCP + seg * 8, x, brick_halo_voxel(a, rows, hv), c0 + seg * 8,
                     cin);
    }
  };
  // ring stage sg holds the KC x BN weight slices of taps sg*kBrickTaps ..
  auto issue_w = [&](int sg, int c0, int buf) {
    __nv_bfloat16* B = Ws + buf * Sh::STAGE;
    for (int v = tid; v < B_VECS; v += kBrickThreads) {
      const int k = v / B_SEGS, seg = v - k * B_SEGS;
      const int tap = sg * kBrickTaps + k / KC, kk = k % KC;
      cp_async16(B + k * BNP + seg * 8,
                 w + (long long)(tap * wcin + c0 + kk) * wcout + n0 + seg * 8, true);
    }
  };

  // this lane's ldmatrix row of each of the warp's two x-rows, at tap 0
  int hrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = warp * 2 + i;
    hrow[i] = ((q / kBrickY) * kHaloY + q % kBrickY) * kHaloX + (lane & 15);
  }
  const int acol = (lane >> 4) * 8;                             // A: k half
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;          // B: k row
  const int bcol = (lane >> 4) * 8;                             // B: n half

  float acc[2][2 * NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int c0 = 0; c0 < wcin; c0 += KC) {
    // the columns are staged; every warp left the last chunk's halo and ring
    __syncthreads();
    issue_halo(c0);
    cp_async_commit();
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      issue_w(st, c0, st);
      cp_async_commit();
    }
    cp_async_wait<S - 1>();   // this thread's halo copies landed
    if (transform)
      for (int v = tid; v < H_VECS; v += kBrickThreads) {
        const int hv = v / SEGS, seg = v - hv * SEGS;
        if (brick_halo_voxel(a, rows, hv) >= 0)
          transform8(Hs + hv * KCP + seg * 8, ssc, ssh, c0 + seg * 8, affine, leaky, a.slope);
      }
    for (int sg = 0; sg < NSTAGES; ++sg) {
      cp_async_wait<S - 2>();   // this thread's copies of stage sg landed
      // every copy and the transform are visible, and every warp has left
      // stage sg - 1, whose ring slot the next issue refills
      __syncthreads();
      if (sg + S - 1 < NSTAGES) issue_w(sg + S - 1, c0, (sg + S - 1) % S);
      cp_async_commit();
#pragma unroll
      for (int tp = 0; tp < kBrickTaps; ++tp) {
        const int tap = sg * kBrickTaps + tp;
        const int shift = ((tap / 9) * kHaloY + tap / 3 % 3) * kHaloX + tap % 3;
        const __nv_bfloat16* B = Ws + (sg % S) * Sh::STAGE + tp * KC * BNP;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            ldmatrix_x4(af[i], Hs + (hrow[i] + shift) * KCP + kk + acol);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, B + (kk + brow) * BNP + j * 16 + bcol);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
              mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the halo and ring are idle: Cs may alias them

  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NF; ++j) {
      const int r = (warp * 2 + i) * kBrickX + g, c = j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(Cs + r * Sh::LDC + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(Cs + (r + 8) * Sh::LDC + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  epilogue<__nv_bfloat16>(a, t, Cs, Sh::LDC, min(BN, a.cout - n0), n0, rows);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores, by box, for the coarse levels: wcin % KC == 0,
// wcout % BN == 0 (the padded widths, HC as the brick path's), and a box
// tile of tz x ty x tx voxels (a 4x4x4 brick
// that divides the volume, or the whole sample of at most kBoxMaxRows
// voxels).  A CTA owns one box (rows padded to 16-row fragments) and BN
// output channels, and the K units [u_begin, u_end) of its split.  A unit
// is one (kz, ky) row of 3 taps of one KC-channel chunk: chunk u / 9.
// Each unit's weight slices take one stage of a kBoxStages-deep cp.async
// ring, and the unit that opens a chunk brings the box's halo for that
// chunk (zero fill outside the volume) into the other of two halo
// buffers, so one pipeline runs through the whole split with no drain
// between chunks.  The halo is transformed once, when its chunk's first
// unit lands.  Warps are WM (along M) x WN (along N); a warp multiplies up
// to MFW 16-row fragments by 16*NFW channels with mma.sync m16n8k16.
//
// Split K adds up in a fixed binary tree over the split index: at each
// level the two CTAs of a pair publish their sums (valid rows only) in
// the workspace slot of their node's first split and bump an integer
// arrival counter; the one that arrives second adds its partner's sums to
// its own accumulators, resets the counter and goes up a level.  The
// root's CTA runs the epilogue.  Each node's value is the sum of its two
// children's, and f32 addition is commutative, so the result does not
// depend on the order of arrival: a repeated call is bit-identical.
// Every CTA of a level reads one partner tile in parallel, where one CTA
// adding all splits in turn would read them all alone.  (A tree of 4-wide
// nodes, 3 levels for 22 splits instead of 5, spilled registers and was
// no faster.)

constexpr int kBoxThreads = 256;    // 8 warps
constexpr int kBoxStages = 3;       // weight-ring stages, one unit each (< kUnitsPerChunk)
constexpr int kBoxEdge = 4;         // the brick edge where it divides the volume
constexpr int kBoxMaxRows = 256;    // else the whole sample, up to this many voxels
constexpr int kUnitsPerChunk = 9;   // (kz, ky) rows of taps
constexpr size_t kSmemLimit = 232448;

template <int NFW, int KC, int WN>
struct BoxShape {
  static constexpr int WM = kBoxThreads / 32 / WN;   // warps along M
  static constexpr int MFW = WN == 2 ? 1 : 2;        // 16-row fragments a warp, at most
  static constexpr int BN = 16 * NFW * WN, BNP = BN + 8, KCP = KC + 8, LDC = BN + 4;
  static constexpr int STAGE = 3 * KC * BNP;         // bf16 per ring stage
};

// Dynamic shared bytes before the columns: two halos and the ring, or the
// f32 tile of the epilogue, which aliases them.
__host__ __device__ inline int box_main_bytes(int halo_voxels, int frags, int kc, int bn) {
  const int main = (2 * halo_voxels * (kc + 8) + kBoxStages * 3 * kc * (bn + 8)) * 2;
  const int cs = frags * 16 * (bn + 4) * 4;
  return ((main > cs ? main : cs) + 15) / 16 * 16;
}

// The voxel of row r of a box: rows run x fastest, then y, then z.
struct BoxRows {
  int z0, y0, x0, ty, tx, Y, X;
  __device__ int operator()(int r) const {
    const int q = r / tx;
    return ((z0 + q / ty) * Y + y0 + q % ty) * X + x0 + r % tx;
  }
};

template <int NFW, int KC, int WN, int HC>
__global__ void __launch_bounds__(kBoxThreads, 2)
miseg_k4_conv_coarse(Args a) {
  using Sh = BoxShape<NFW, KC, WN>;
  constexpr int BN = Sh::BN, BNP = Sh::BNP, KCP = Sh::KCP, WM = Sh::WM, MFW = Sh::MFW;
  constexpr int SEGS = KC / 8, B_SEGS = BN / 8, B_VECS = 3 * KC * B_SEGS;
  constexpr int S = kBoxStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int partner_goes_on;
  const int tz = a.tz, ty = a.ty, tx = a.tx;
  const int HY = ty + 2, HX = tx + 2, HV = (tz + 2) * HY * HX, H_VECS = HV * SEGS;
  const int rows = tz * ty * tx, frags = (rows + 15) / 16;
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][HV][KCP]
  __nv_bfloat16* Ws = Hs + 2 * HV * KCP;                         // [S][3][KC][BNP]
  float* ssc = reinterpret_cast<float*>(smem + a.smem_main);
  float* ssh = ssc + a.wcin;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % WM, wn = warp / WM;
  Tile t;
  t.b = blockIdx.x / a.n_tiles;
  t.tile = blockIdx.x % a.n_tiles;
  t.nvalid = rows;
  t.tile_global = blockIdx.x;
  const int nbx = a.X / tx, nby = a.Y / ty;
  const BoxRows box{t.tile / (nbx * nby) * tz, t.tile / nbx % nby * ty, t.tile % nbx * tx,
                    ty, tx, a.Y, a.X};
  const int n0 = blockIdx.y * BN;
  const int cin = a.cin, wcin = a.wcin, wcout = a.wcout;
  const bool affine = a.scale != nullptr, leaky = a.leaky != 0;
  const bool transform = affine || leaky;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x) + (long long)t.b * a.Sx * cin;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int per = (a.nsteps + a.splits - 1) / a.splits;
  const int u_begin = blockIdx.z * per, n = min(a.nsteps, u_begin + per) - u_begin;

  if (affine) stage_columns(a, t.b, ssc, ssh, kBoxThreads);
  __syncthreads();   // the columns are staged before the first transform

  // halo voxel hv -> its flat voxel index, or -1 outside the volume
  auto halo_voxel = [&](int hv) {
    const int hx = hv % HX, q = hv / HX, hy = q % HY, hz = q / HY;
    const int zz = box.z0 - 1 + hz, yy = box.y0 - 1 + hy, xx = box.x0 - 1 + hx;
    const bool in = zz >= a.zlo && zz < a.zhi && (unsigned)yy < (unsigned)a.Y &&
                    (unsigned)xx < (unsigned)a.X;
    return in ? ((zz + a.zoff) * a.Y + yy) * a.X + xx : -1;
  };
  // unit k of the split into ring slot k % S; the chunk's halo with the
  // unit that opens it
  auto copy_unit = [&](int k) {
    const int u = u_begin + k, chunk = u / kUnitsPerChunk, c0 = chunk * KC;
    if (k == 0 || u % kUnitsPerChunk == 0) {
      __nv_bfloat16* H = Hs + (chunk & 1) * HV * KCP;
      for (int v = tid; v < H_VECS; v += kBoxThreads) {
        const int hv = v / SEGS, seg = v - hv * SEGS;
        copy_halo8<HC>(H + hv * KCP + seg * 8, x, halo_voxel(hv), c0 + seg * 8, cin);
      }
    }
    __nv_bfloat16* B = Ws + (k % S) * Sh::STAGE;
    const int tap0 = u % kUnitsPerChunk * 3;
    for (int v = tid; v < B_VECS; v += kBoxThreads) {
      const int kr = v / B_SEGS, seg = v - kr * B_SEGS;
      const int tap = tap0 + kr / KC, kk = kr % KC;
      cp_async16(B + kr * BNP + seg * 8,
                 w + (long long)(tap * wcin + c0 + kk) * wcout + n0 + seg * 8, true);
    }
  };

  // this lane's ldmatrix row (halo row at tap 0) of each of its fragments;
  // padding rows past the box read row 0 and are never stored
  int hrow[MFW];
  bool has[MFW];
#pragma unroll
  for (int i = 0; i < MFW; ++i) {
    const int f = wm + i * WM;
    has[i] = f < frags;
    int r = f * 16 + (lane & 15);
    if (r >= rows) r = 0;
    const int q = r / tx;
    hrow[i] = ((q / ty) * HY + q % ty) * HX + r % tx;
  }
  const int acol = (lane >> 4) * 8;                             // A: k half
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;          // B: k row
  const int bcol = (lane >> 4) * 8 + wn * NFW * 16;             // B: n half of this warp

  float acc[MFW][2 * NFW][4];
#pragma unroll
  for (int i = 0; i < MFW; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NFW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n) copy_unit(st);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    const int u = u_begin + k, chunk = u / kUnitsPerChunk;
    const __nv_bfloat16* H = Hs + (chunk & 1) * HV * KCP;
    cp_async_wait<S - 2>();   // this thread's copies of unit k (and its halo) landed
    if (transform && (k == 0 || u % kUnitsPerChunk == 0))
      for (int v = tid; v < H_VECS; v += kBoxThreads) {   // halo outside the volume stays 0
        const int hv = v / SEGS, seg = v - hv * SEGS;
        if (halo_voxel(hv) >= 0)
          transform8(Hs + (chunk & 1) * HV * KCP + hv * KCP + seg * 8, ssc, ssh,
                     chunk * KC + seg * 8, affine, leaky, a.slope);
      }
    // every copy and transform of unit k is visible, and every warp has
    // left unit k - 1, whose ring slot the next copy refills; the other
    // halo buffer was last read a full chunk ago
    __syncthreads();
    if (k + S - 1 < n) copy_unit(k + S - 1);
    cp_async_commit();
    if (!has[0]) continue;   // a warp past the box's fragments only copies
    const int zy = u % kUnitsPerChunk;
    const int shift = ((zy / 3) * HY + zy % 3) * HX;
    const __nv_bfloat16* Bst = Ws + (k % S) * Sh::STAGE;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const __nv_bfloat16* B = Bst + kx * KC * BNP;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[MFW][4];
#pragma unroll
        for (int i = 0; i < MFW; ++i)
          if (has[i]) ldmatrix_x4(af[i], H + (hrow[i] + shift + kx) * KCP + kk + acol);
#pragma unroll
        for (int j = 0; j < NFW; ++j) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, B + (kk + brow) * BNP + j * 16 + bcol);
#pragma unroll
          for (int i = 0; i < MFW; ++i)
            if (has[i]) {
              mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
              mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // apply f to each (row, column, float2 of sums) of this thread that lies
  // in the box
  const int g = lane >> 2, tq = lane & 3;
  auto each_pair = [&](auto f) {
#pragma unroll
    for (int i = 0; i < MFW; ++i)
      if (has[i])
#pragma unroll
        for (int j = 0; j < 2 * NFW; ++j) {
          const int r = (wm + i * WM) * 16 + g, c = wn * NFW * 16 + j * 8 + 2 * tq;
          if (r < rows) f(r, c, acc[i][j][0], acc[i][j][1]);
          if (r + 8 < rows) f(r + 8, c, acc[i][j][2], acc[i][j][3]);
        }
  };
  if (a.splits > 1) {
    const long long split_stride = a.n_parts * rows * wcout;
    float* slots = a.work + t.tile_global * rows * wcout + n0;   // + first split * split_stride
    int* counters = a.counters + (t.tile_global * gridDim.y + blockIdx.y) * a.tree;
    int node = blockIdx.z, width = 1, count = a.splits;   // node covers splits node*width ..
    for (int level = 0; count > 1; ++level) {
      const int partner = node ^ 1;
      if (partner < count) {
        float* mine = slots + (long long)node * width * split_stride;
        each_pair([&](int r, int c, float& v0, float& v1) {
          *reinterpret_cast<float2*>(mine + (long long)r * wcout + c) = make_float2(v0, v1);
        });
        __threadfence();   // the sums are visible device-wide before the arrival
        __syncthreads();
        if (tid == 0) {
          int* counter = counters + (a.tree >> (level + 1)) + (node >> 1);
          const int first = atomicAdd(counter, 1) == 0;
          if (!first) *counter = 0;   // both have arrived: ready for the next call
          partner_goes_on = first;
        }
        __syncthreads();
        if (partner_goes_on) return;
        __threadfence();
        // all of a fragment's loads in flight at once, then the adds
        const float* theirs = slots + (long long)partner * width * split_stride;
#pragma unroll
        for (int i = 0; i < MFW; ++i) {
          if (!has[i]) continue;
          float2 p[2 * NFW][2];
#pragma unroll
          for (int j = 0; j < 2 * NFW; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = (wm + i * WM) * 16 + g + 8 * h, c = wn * NFW * 16 + j * 8 + 2 * tq;
              p[j][h] = r < rows ? __ldcg(reinterpret_cast<const float2*>(
                                       theirs + (long long)r * wcout + c))
                                 : make_float2(0.f, 0.f);
            }
#pragma unroll
          for (int j = 0; j < 2 * NFW; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              acc[i][j][2 * h] += p[j][h].x;
              acc[i][j][2 * h + 1] += p[j][h].y;
            }
        }
      }
      node >>= 1;
      width <<= 1;
      count = (count + 1) >> 1;
    }
  }
  __syncthreads();   // the halos and ring are idle: Cs may alias them
  float* Cs = reinterpret_cast<float*>(smem);
  each_pair([&](int r, int c, float& v0, float& v1) {
    *reinterpret_cast<float2*>(Cs + r * Sh::LDC + c) = make_float2(v0, v1);
  });
  __syncthreads();
  epilogue<__nv_bfloat16>(a, t, Cs, Sh::LDC, min(BN, a.cout - n0), n0, box);
}

// ---------------------------------------------------------------------------
// bf16 Cin = 1 on the tensor cores, by brick: wcout % (16 * NF) == 0 (Cout
// padded to 16, the packed weights' columns past Cout zero; y and the
// statistics take the real columns alone) and the volume divides into 4 x
// 4 x 16 bricks.  A CTA owns BN output channels and
// walks bricks blockIdx.x, + gridDim.x, ...; its B fragments (the [32, BN]
// weight slice, taps 27..31 zero) stay in registers for every brick.  Per
// brick it stores the 6 x 6 x 18 one-channel halo, fetched into registers
// while the previous brick ran, in shared memory with the prologue applied
// once and rounded to bf16 (the halo outside the volume stays 0).  Lane
// (g, tq) of a warp gathers the A fragment of its rows g and g + 8 of an
// x-row straight from the halo: columns 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of
// each 16-tap k-step are the halo values at those taps' offsets, so the
// 256 x 32 im2col rows are never staged.  Each warp multiplies its two
// x-rows (32 voxels) by BN channels, one x-row at a time.
//
// The call moves little but its output (85 MB of y at 96^3 -> 48), so its
// epilogue is its own: the shared one keeps an f32 tile and reads it back
// with scalar, bank-conflicting accesses and a thread per column, and here
// that shared-memory traffic, not the MMAs or the stores, bounded the
// kernel (on an H100 it ran at 4.4x its byte bound).  The sums are rounded to bf16 in
// registers into a bf16 tile with conflict-free 16-byte rows; y leaves it
// 16 bytes at a time; the statistics of the rounded values are taken
// two-pass by every thread, a column pair over one of SLICES row slices,
// and the slices merge by Chan's formula in slice order (deterministic).

constexpr int kCin1K = 32;   // 27 taps zero-padded to two k-steps of 16
constexpr int kCin1HaloPer = (kHalo + kBrickThreads - 1) / kBrickThreads;   // 3

template <int NF>
struct Cin1Shape {
  static constexpr int BN = 16 * NF, BNP = BN + 8, YP = BN + 8;   // bf16 row pitches
  static constexpr int PAIRS = BN / 2, SLICES = kBrickThreads / PAIRS;
  static constexpr int SLICE_ROWS = (kBrick + SLICES - 1) / SLICES;
  static constexpr size_t W = (size_t)kCin1K * BNP * sizeof(__nv_bfloat16);
  static constexpr size_t HALO = ((size_t)kHalo * sizeof(__nv_bfloat16) + 15) / 16 * 16;
  static constexpr size_t YS = (size_t)kBrick * YP * sizeof(__nv_bfloat16);
  static constexpr size_t ST = (size_t)2 * SLICES * BN * sizeof(float);   // (mean, M2) a slice
  static constexpr size_t BYTES = W + HALO + YS + ST;
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int NF>
__global__ void __launch_bounds__(kBrickThreads, 3)
miseg_k4_conv_cin1(Args a) {
  using Sh = Cin1Shape<NF>;
  constexpr int BN = Sh::BN, BNP = Sh::BNP, YP = Sh::YP, PAIRS = Sh::PAIRS;
  constexpr int SLICES = Sh::SLICES, SLICE_ROWS = Sh::SLICE_ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);           // [kCin1K][BNP]
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem + Sh::W);   // [kHalo]
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem + Sh::W + Sh::HALO);   // [kBrick][YP]
  float* st_mean = reinterpret_cast<float*>(smem + Sh::W + Sh::HALO + Sh::YS);   // [SLICES][BN]
  float* st_m2 = st_mean + SLICES * BN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.y * BN;
  const bool affine = a.scale != nullptr, leaky = a.leaky != 0;
  const bool transform = affine || leaky;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);   // [B, S] (cin = 1)
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);   // [27, wcout]
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const int n_tiles = a.n_tiles, n_parts = (int)a.n_parts;   // the bricks of all samples
  const int ncols = min(BN, a.cout - n0);                      // the real ones of BN
  const int nbx = a.X / kBrickX, nby = a.Y / kBrickY;
  auto brick_rows = [&](int tile) {
    return BrickRows{tile / (nbx * nby) * kBrickZ, tile / nbx % nby * kBrickY,
                     tile % nbx * kBrickX, a.Y, a.X};
  };

  for (int i = tid; i < kCin1K * BN; i += kBrickThreads) {
    const int k = i / BN, n = i - k * BN;
    Ws[k * BNP + n] = k < 27 ? w[(long long)k * a.wcout + n0 + n] : zero;
  }
  __syncthreads();
  uint32_t bfr[2][NF][4];   // [k-step][16 columns]
  {
    const int brow = (lane & 7) + ((lane >> 3) & 1) * 8, bcol = (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        ldmatrix_x4_trans(bfr[ks][j], Ws + (ks * 16 + brow) * BNP + j * 16 + bcol);
  }
  // this lane's taps: column 2tq + e + 8h of k-step ks is tap ks*16 + 8h +
  // 2tq + e, at halo offset toff (-1 past the 27 taps: a zero)
  const int g = lane >> 2, tq = lane & 3;
  int toff[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tap = ks * 16 + h * 8 + 2 * tq + e;
        toff[ks][h * 2 + e] =
            tap < 27 ? ((tap / 9) * kHaloY + tap / 3 % 3) * kHaloX + tap % 3 : -1;
      }
  auto at = [&](int hr, int off) { return off >= 0 ? Hs[hr + off] : zero; };

  // the halo of brick p into registers (0 outside the volume)
  __nv_bfloat16 hreg[kCin1HaloPer];
  bool hin[kCin1HaloPer];
  auto fetch = [&](int p) {
    const int b = p / n_tiles;
    const BrickRows rows = brick_rows(p - b * n_tiles);
    const __nv_bfloat16* xs = x + (long long)b * a.Sx;
#pragma unroll
    for (int j = 0; j < kCin1HaloPer; ++j) {
      const int hv = tid + j * kBrickThreads;
      const int m = hv < kHalo ? brick_halo_voxel(a, rows, hv) : -1;
      hin[j] = m >= 0;
      hreg[j] = m >= 0 ? xs[m] : zero;
    }
  };

  // the statistics' share of this thread: column pair sp of row slice ss
  const int sp = tid % PAIRS, ss = tid / PAIRS;
  const int sr0 = ss * SLICE_ROWS, sr1 = min(kBrick, sr0 + SLICE_ROWS);

  int p = blockIdx.x;
  if (p < n_parts) fetch(p);
  for (; p < n_parts; p += gridDim.x) {
    const int b = p / n_tiles;
    const BrickRows rows = brick_rows(p - b * n_tiles);
    const float sc = affine ? a.scale[b] : 1.0f, sh = affine ? a.shift[b] : 0.0f;
    __syncthreads();   // every warp left the last brick's halo, tile and slices
#pragma unroll
    for (int j = 0; j < kCin1HaloPer; ++j) {
      const int hv = tid + j * kBrickThreads;
      if (hv < kHalo)
        Hs[hv] = transform && hin[j]
                     ? __float2bfloat16(prologue(__bfloat162float(hreg[j]), sc, sh, affine, leaky,
                                                 a.slope))
                     : hreg[j];
    }
    __syncthreads();
    if (p + (int)gridDim.x < n_parts) fetch(p + gridDim.x);   // in flight during this brick
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = warp * 2 + i;   // the brick's x-row
      const int hr = ((q / kBrickY) * kHaloY + q % kBrickY) * kHaloX + g;
      float acc[2 * NF][4];
#pragma unroll
      for (int j = 0; j < 2 * NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[4];
        af[0] = pack_bf16(at(hr, toff[ks][0]), at(hr, toff[ks][1]));
        af[1] = pack_bf16(at(hr + 8, toff[ks][0]), at(hr + 8, toff[ks][1]));
        af[2] = pack_bf16(at(hr, toff[ks][2]), at(hr, toff[ks][3]));
        af[3] = pack_bf16(at(hr + 8, toff[ks][2]), at(hr + 8, toff[ks][3]));
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          mma_bf16(acc[2 * j], af, bfr[ks][j][0], bfr[ks][j][1]);
          mma_bf16(acc[2 * j + 1], af, bfr[ks][j][2], bfr[ks][j][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * NF; ++j) {   // round once, into the bf16 tile
        const int r = q * kBrickX + g, c = j * 8 + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(Ys + r * YP + c) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(Ys + (r + 8) * YP + c) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();
    // y, 16 bytes at a time
    if (ncols == BN) {
      constexpr int CHUNKS = BN / 8;
      for (int e = tid; e < kBrick * CHUNKS; e += kBrickThreads) {
        const int r = e / CHUNKS, k = e - r * CHUNKS;
        *reinterpret_cast<uint4*>(y + ((long long)b * a.S + rows(r)) * a.cout + n0 + k * 8) =
            *reinterpret_cast<const uint4*>(Ys + r * YP + k * 8);
      }
    } else if (ncols % 8 == 0 && a.cout % 8 == 0) {   // a padded Cout's real columns
      const int chunks = ncols / 8;
      for (int e = tid; e < kBrick * chunks; e += kBrickThreads) {
        const int r = e / chunks, k = e - r * chunks;
        *reinterpret_cast<uint4*>(y + ((long long)b * a.S + rows(r)) * a.cout + n0 + k * 8) =
            *reinterpret_cast<const uint4*>(Ys + r * YP + k * 8);
      }
    } else {   // 8 bytes at a time: rows of Cout % 8 == 4 are only 8-byte aligned
      const int chunks = ncols / 4;
      for (int e = tid; e < kBrick * chunks; e += kBrickThreads) {
        const int r = e / chunks, k = e - r * chunks;
        *reinterpret_cast<uint2*>(y + ((long long)b * a.S + rows(r)) * a.cout + n0 + k * 4) =
            *reinterpret_cast<const uint2*>(Ys + r * YP + k * 4);
      }
    }
    // the statistics: two passes over this thread's rows of a column pair
    if (ss < SLICES) {
      float2 sum = make_float2(0.0f, 0.0f);
      for (int r = sr0; r < sr1; ++r) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ys + r * YP + 2 * sp));
        sum.x += v.x;
        sum.y += v.y;
      }
      const float cnt = (float)(sr1 - sr0);
      const float2 mean = make_float2(sum.x / cnt, sum.y / cnt);
      float2 m2 = make_float2(0.0f, 0.0f);
      for (int r = sr0; r < sr1; ++r) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ys + r * YP + 2 * sp));
        const float dx = v.x - mean.x, dy = v.y - mean.y;
        m2.x = fmaf(dx, dx, m2.x);
        m2.y = fmaf(dy, dy, m2.y);
      }
      st_mean[ss * BN + 2 * sp] = mean.x;
      st_mean[ss * BN + 2 * sp + 1] = mean.y;
      st_m2[ss * BN + 2 * sp] = m2.x;
      st_m2[ss * BN + 2 * sp + 1] = m2.y;
    }
    __syncthreads();
    for (int c = tid; c < ncols; c += kBrickThreads) {   // the slices, merged in order
      float n = (float)SLICE_ROWS, mean = st_mean[c], m2 = st_m2[c];
#pragma unroll
      for (int sl = 1; sl < SLICES; ++sl) {
        const float nb = (float)(min(kBrick, (sl + 1) * SLICE_ROWS) - sl * SLICE_ROWS);
        const float tot = n + nb, f = nb / tot, d = st_mean[sl * BN + c] - mean;
        mean = fmaf(d, f, mean);
        m2 = m2 + st_m2[sl * BN + c] + d * d * (n * f);
        n = tot;
      }
      a.part[(long long)p * a.cout + n0 + c] = mean;
      a.part[(a.n_parts + p) * a.cout + n0 + c] = m2;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores, f32 FMA: f32, and the bf16 calls no tensor-core path takes.
// A CTA computes kTile voxels by BN columns (16, 32 or 64: the least that
// covers Cout, else 64): 256 threads, each 4 columns of TM rows.

template <int BN>
struct FmaShape {
  static constexpr int CG = BN / 4;            // column groups of 4
  static constexpr int TM = kTile / (kThreads / CG);   // rows a thread: 2, 4, 8
  static constexpr int LDC = BN + 1;
  static constexpr int KB = kFmaKc * BN / kThreads;    // weights a thread a step
  static constexpr int AB = 2 * kFmaKc * kFmaRowPad + 2 * kFmaKc * BN;
  static constexpr int POOL = AB > kTile * LDC ? AB : kTile * LDC;
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
miseg_k4_conv_fma(Args a) {
  using Sh = FmaShape<BN>;
  constexpr int TM = Sh::TM, KB = Sh::KB;
  __shared__ __align__(16) float pool[Sh::POOL];
  __shared__ int roff[kTile];
  __shared__ unsigned rmask[kTile];
  float* As = pool;                              // [2][kFmaKc][kFmaRowPad], k-major
  float* Bs = pool + 2 * kFmaKc * kFmaRowPad;    // [2][kFmaKc][BN]

  const int tid = threadIdx.x;
  const int tr = tid / Sh::CG, tc = tid % Sh::CG;   // rows tr*TM.., cols tc*4..
  const Tile t = tile_of(a);
  const int n0 = blockIdx.y * BN;
  const int cin = a.cin, cout = a.cout, K = 27 * cin;
  const bool affine = a.scale != nullptr, leaky = a.leaky != 0;
  const T* x = static_cast<const T*>(a.x) + (long long)t.b * a.Sx * cin;
  const T* w = static_cast<const T*>(a.w);
  const float* sc = affine ? a.scale + (long long)t.b * cin : nullptr;
  const float* sh = affine ? a.shift + (long long)t.b * cin : nullptr;
  int k_begin, k_end;
  split_range(a, k_begin, k_end);

  tile_rows(a, t, roff, rmask);
  __syncthreads();

  constexpr int kA = kTile * kFmaKc / kThreads;   // 8
  float ra[kA], rb[KB];

  auto load = [&](int s) {
    const int k0 = s * kFmaKc;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kFmaKc, k = k0 + e % kFmaKc;
      float v = 0.0f;  // halo and K tail: zero AFTER the transform
      if (k < K) {
        const int tap = k / cin, ci = k - tap * cin;
        if ((rmask[r] >> tap) & 1u) {
          v = prologue(to_f32(x[(roff[r] + tap_delta(a, tap)) * cin + ci]),
                       affine ? __ldg(sc + ci) : 1.0f, affine ? __ldg(sh + ci) : 0.0f,
                       affine, leaky, a.slope);
          v = to_f32(from_f32<T>(v));
        }
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / BN, n = n0 + e % BN;
      rb[i] = (k < K && n < cout) ? to_f32(w[(long long)k * cout + n]) : 0.0f;
    }
  };

  auto store = [&](int buf) {
    float* A = As + buf * kFmaKc * kFmaRowPad;
    float* B = Bs + buf * kFmaKc * BN;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const int e = tid + i * kThreads;
      A[(e % kFmaKc) * kFmaRowPad + e / kFmaKc] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int e = tid + i * kThreads;
      B[(e / BN) * BN + e % BN] = rb[i];
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  if (k_begin < k_end) {
    load(k_begin);
    store(0);
  }
  __syncthreads();
  for (int s = k_begin; s < k_end; ++s) {
    const int buf = (s - k_begin) & 1;
    if (s + 1 < k_end) load(s + 1);
    const float* A = As + buf * kFmaKc * kFmaRowPad + tr * TM;
    const float* B = Bs + buf * kFmaKc * BN + tc * 4;
#pragma unroll
    for (int kk = 0; kk < kFmaKc; ++kk) {
      float av[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 q = *reinterpret_cast<const float4*>(A + kk * kFmaRowPad + i);
          av[i] = q.x; av[i + 1] = q.y; av[i + 2] = q.z; av[i + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; i += 2) {
          const float2 q = *reinterpret_cast<const float2*>(A + kk * kFmaRowPad + i);
          av[i] = q.x; av[i + 1] = q.y;
        }
      }
      const float4 bv = *reinterpret_cast<const float4*>(B + kk * BN);
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    // buf ^ 1 was last read in step s - 1, which every thread has left
    if (s + 1 < k_end) store(buf ^ 1);
    __syncthreads();
  }

  if (a.splits > 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tc * 4 + j;
        if (c < cout) *work_at(a, t, tr * TM + i, c) = acc[i][j];
      }
    return;
  }
  float* Cs = pool;  // aliases the A/B buffers
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(tr * TM + i) * Sh::LDC + tc * 4 + j] = acc[i][j];
  __syncthreads();
  epilogue<T>(a, t, Cs, Sh::LDC, min(BN, cout - n0), n0, TileRows{t.tile * kTile});
}

// Split-K: add the splits' partial sums of one BN-column block in split
// order, then the epilogue.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
miseg_k4_splitk_reduce(Args a) {
  constexpr int LDC = FmaShape<BN>::LDC;
  __shared__ float Cs[kTile * LDC];
  const Tile t = tile_of(a);
  const int n0 = blockIdx.y * BN, ncols = min(BN, a.cout - n0);
  const long long split_stride = a.n_parts * kTile * a.cout;
  for (int e = threadIdx.x; e < t.nvalid * ncols; e += kThreads) {
    const int r = e / ncols, c = e - r * ncols;
    const float* src = a.work + (t.tile_global * kTile + r) * a.cout + n0 + c;
    float s = 0.0f;
    for (int sp = 0; sp < a.splits; ++sp) s += src[sp * split_stride];
    Cs[r * LDC + c] = s;
  }
  __syncthreads();
  epilogue<T>(a, t, Cs, LDC, ncols, n0, TileRows{t.tile * kTile});
}

// bf16 channels the tensor-core paths take, padded to 16 in shared memory
// where they are no multiple of it: multiples of 4, whose x rows and y
// rows are 8-byte aligned.
bool on_tensor_cores(int dtype, int cin, int cout) {
  return dtype == 1 && cin % 4 == 0 && cout % 4 == 0;
}

// How the halo of x with cin channels, padded to wcin, is copied (HC).
int halo_copy(int cin, int wcin) {
  return cin == wcin ? kWholeChunks : cin % 8 == 0 ? 8 : 4;
}

bool bricks_divide(int Z, int Y, int X) {
  return Z % kBrickZ == 0 && Y % kBrickY == 0 && X % kBrickX == 0;
}

// The Cin = 1 path: bf16 on the tensor cores by brick.
bool by_cin1(int dtype, int Z, int Y, int X, int cin, int cout) {
  return dtype == 1 && cin == 1 && cout % 4 == 0 && bricks_divide(Z, Y, X);
}

// The brick path: tensor cores, and bricks that divide the volume, so
// every statistics tile holds kBrick voxels.
bool by_brick(int dtype, int Z, int Y, int X, int cin, int cout) {
  return on_tensor_cores(dtype, cin, cout) && bricks_divide(Z, Y, X);
}

// The brick path's input-channel chunk where Cin % 16 == 0 (no padding)
// and its 16-column output fragments.
int brick_kc(int cin) {
  return cin % 64 == 0 ? 64 : cin % 48 == 0 ? 48 : cin % 32 == 0 ? 32 : 16;
}

int brick_nf(int cout) {
  return cout % 64 == 0 ? 4 : cout % 48 == 0 ? 3 : cout % 32 == 0 ? 2 : 1;
}

// A Cin that is no multiple of 16, padded: the chunk KC of `kcs` (n of
// them) and the width wcin = a multiple of KC that cost the least, taking
// a chunk's own work (its halo copy and transform, and one barrier a
// weight stage) as worth 16 channels of MMAs: wcin + 16 * chunks, ties to
// the narrower wcin.  72 channels: 2 chunks of 48 (96), not 5 of 16.
void pad_cin(int cin, const int* kcs, int n, int& wcin, int& kc) {
  int best = 1 << 30;
  for (int i = 0; i < n; ++i) {
    const int w = (cin + kcs[i] - 1) / kcs[i] * kcs[i], cost = w + 16 * (w / kcs[i]);
    if (cost < best || (cost == best && w < wcin)) {
      best = cost;
      wcin = w;
      kc = kcs[i];
    }
  }
}

// A Cout that is no multiple of 16, padded to the 16-column count (up to 3
// past the least) that leaves the fewest column blocks, blocks(cn) each
// staging the halo anew; ties to the narrower.  72 channels: 96 in one
// block of 96 (or 48, 48), not 80 in five of 16.
template <typename Blocks>
int pad_cout(int cout, Blocks blocks) {
  const int cn0 = (cout + 15) / 16;
  int best = cn0;
  for (int cn = cn0 + 1; cn <= cn0 + 3; ++cn)
    if (blocks(cn) < blocks(best)) best = cn;
  return 16 * best;
}

int brick_blocks(int cn) { return cn / brick_nf(16 * cn); }

int device_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Splits of K so that a call fills the card with two CTAs per SM, keeping
// at least kMinStepsPerSplit steps in each; no split is empty.
int plan_splits(long long ctas, int nsteps) {
  const long long want = 2LL * device_sms();
  if (ctas >= want) return 1;
  int splits = (int)((want + ctas - 1) / ctas);
  splits = min(min(splits, kMaxSplits), max(1, nsteps / kMinStepsPerSplit));
  const int per = (nsteps + splits - 1) / splits;
  return (nsteps + per - 1) / per;
}

enum class Path { cin1, brick, coarse, fma };

// How a call of one shape runs: its path, statistics tile, K steps (units
// on the coarse path), output-channel blocks and K splits, and the widths
// of its packed weights.
struct Plan {
  Path path;
  int tile, nsteps, nblocks, splits;
  int wcin, wcout;                          // cin, cout, padded on the tensor cores
  int hc;                                   // tensor cores: how the x halo is copied
  int kc;                                   // brick and coarse paths: the channel chunk
  int bn;                                   // CUDA-core path: the column block
  int tz, ty, tx, nfw, wn, smem_main;       // the coarse path's box and kernel
  int tree;                                 // its counters per (tile, N block)
};

// The coarse path's box and kernel shape, where it takes the call: a
// 4x4x4 brick that divides the volume, else the whole sample if it holds
// at most kBoxMaxRows voxels; KC = 32 unless the channels or the shared
// memory want 16.  Channels that are no multiple of 16 are padded (p.wcin,
// p.wcout; pad_cin, pad_cout).
bool coarse_plan(int Z, int Y, int X, int cin, int cout, Plan& p) {
  if (Z % kBoxEdge == 0 && Y % kBoxEdge == 0 && X % kBoxEdge == 0) {
    p.tz = p.ty = p.tx = kBoxEdge;
  } else if ((long long)Z * Y * X <= kBoxMaxRows) {
    p.tz = Z;
    p.ty = Y;
    p.tx = X;
  } else {
    return false;
  }
  const int rows = p.tz * p.ty * p.tx, frags = (rows + 15) / 16;
  // two warps along N while one fragment a warp covers the box (WM = 4),
  // and 16-column fragments a warp
  auto wn_of = [&](int cn) { return frags <= kBoxThreads / 64 && cn % 2 == 0 ? 2 : 1; };
  auto nfw_of = [&](int cn) {
    const int per = cn / wn_of(cn);
    return per % 4 == 0 ? 4 : per % 3 == 0 ? 3 : per % 2 == 0 ? 2 : 1;
  };
  const int kcs[2] = {32, 16};
  p.wcin = cin;
  p.wcout = cout % 16 ? pad_cout(cout, [&](int cn) { return cn / (wn_of(cn) * nfw_of(cn)); })
                      : cout;
  if (cin % 16) pad_cin(cin, kcs, 2, p.wcin, p.kc);   // the loop below picks the chunk
  const int cn = p.wcout / 16;
  p.wn = wn_of(cn);
  p.nfw = nfw_of(cn);
  const int bn = 16 * p.nfw * p.wn, halo = (p.tz + 2) * (p.ty + 2) * (p.tx + 2);
  for (const int kc : kcs) {
    if (p.wcin % kc) continue;
    const int main = box_main_bytes(halo, frags, kc, bn);
    if ((size_t)main + 2 * (size_t)p.wcin * sizeof(float) + 16 > kSmemLimit) continue;
    p.kc = kc;
    p.smem_main = main;
    p.tile = rows;
    p.nsteps = p.wcin / kc * kUnitsPerChunk;
    p.nblocks = p.wcout / bn;
    return true;
  }
  return false;
}

Plan plan_call(int dtype, int B, int Z, int Y, int X, int cin, int cout) {
  Plan p{};
  const long long s = (long long)Z * Y * X;
  p.wcin = cin;
  p.wcout = cout;
  if (by_cin1(dtype, Z, Y, X, cin, cout)) {
    p.path = Path::cin1;
    p.wcout = cout % 16 ? pad_cout(cout, brick_blocks) : cout;
    p.tile = kBrick;
    p.nblocks = p.wcout / (16 * brick_nf(p.wcout));
    p.splits = 1;
  } else if (by_brick(dtype, Z, Y, X, cin, cout)) {
    p.path = Path::brick;
    p.wcout = cout % 16 ? pad_cout(cout, brick_blocks) : cout;
    if (cin % 16) {   // the padded instances have chunks of 48, 32 and 16
      const int kcs[3] = {48, 32, 16};
      pad_cin(cin, kcs, 3, p.wcin, p.kc);
    } else {
      p.kc = brick_kc(cin);
    }
    p.hc = halo_copy(cin, p.wcin);
    p.tile = kBrick;
    p.nblocks = p.wcout / (16 * brick_nf(p.wcout));
    p.splits = 1;
  } else if (on_tensor_cores(dtype, cin, cout) && coarse_plan(Z, Y, X, cin, cout, p)) {
    // split only where the tiles leave SMs idle, into about one CTA an SM
    p.path = Path::coarse;
    p.hc = halo_copy(cin, p.wcin);
    const long long base = B * (s / p.tile) * p.nblocks;
    const int sms = device_sms();
    p.splits = 1;
    if (base < sms) {
      const long long fill = (sms + base - 1) / base;
      const int want = fill < p.nsteps ? (int)fill : p.nsteps;
      const int per = (p.nsteps + want - 1) / want;
      p.splits = (p.nsteps + per - 1) / per;
    }
    for (p.tree = 1; p.tree < p.splits;) p.tree *= 2;
  } else {   // coarse_plan may have padded the widths before it declined
    p.path = Path::fma;
    p.wcin = cin;
    p.wcout = cout;
    p.tile = kTile;
    p.nsteps = (27 * cin + kFmaKc - 1) / kFmaKc;
    p.bn = cout <= 16 ? 16 : cout <= 32 ? 32 : 64;
    p.nblocks = (cout + p.bn - 1) / p.bn;
    p.splits = plan_splits(B * ((s + kTile - 1) / kTile) * p.nblocks, p.nsteps);
  }
  return p;
}

template <typename Kernel>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NF, int KC, int HC>
cudaError_t launch_brick_kc(const Args& a, dim3 grid, cudaStream_t stream) {
  return launch_smem(miseg_k4_conv_brick<NF, KC, HC>, grid, kBrickThreads,
                     BrickShape<NF, KC>::BYTES + 2 * (size_t)a.wcin * sizeof(float), a, stream);
}

template <int NF, int HC>
cudaError_t launch_brick_hc(const Args& a, dim3 grid, int kc, cudaStream_t stream) {
  switch (kc) {
    case 48: return launch_brick_kc<NF, 48, HC>(a, grid, stream);
    case 32: return launch_brick_kc<NF, 32, HC>(a, grid, stream);
    default: return launch_brick_kc<NF, 16, HC>(a, grid, stream);
  }
}

template <int NF>
cudaError_t launch_brick_nf(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  if (p.hc == 8) return launch_brick_hc<NF, 8>(a, grid, p.kc, stream);
  if (p.hc == 4) return launch_brick_hc<NF, 4>(a, grid, p.kc, stream);
  if (p.kc == 64) return launch_brick_kc<NF, 64, kWholeChunks>(a, grid, stream);
  return launch_brick_hc<NF, kWholeChunks>(a, grid, p.kc, stream);
}

cudaError_t launch_brick(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  switch (brick_nf(a.wcout)) {
    case 4: return launch_brick_nf<4>(a, grid, p, stream);
    case 3: return launch_brick_nf<3>(a, grid, p, stream);
    case 2: return launch_brick_nf<2>(a, grid, p, stream);
    default: return launch_brick_nf<1>(a, grid, p, stream);
  }
}

// A grid of as many CTAs as fit on the card at once (at most one per
// brick); each walks its bricks.
template <int NF>
cudaError_t launch_cin1_nf(const Args& a, int nblocks, cudaStream_t stream) {
  const auto kernel = miseg_k4_conv_cin1<NF>;
  const size_t smem = Cin1Shape<NF>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBrickThreads, smem);
  if (err != cudaSuccess) return err;
  const long long fit = (long long)device_sms() * (per_sm > 0 ? per_sm : 1) / nblocks;
  const dim3 grid((unsigned)min(a.n_parts, fit > 0 ? fit : 1LL), nblocks);
  kernel<<<grid, kBrickThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_cin1(const Args& a, int nblocks, cudaStream_t stream) {
  switch (brick_nf(a.wcout)) {
    case 4: return launch_cin1_nf<4>(a, nblocks, stream);
    case 3: return launch_cin1_nf<3>(a, nblocks, stream);
    case 2: return launch_cin1_nf<2>(a, nblocks, stream);
    default: return launch_cin1_nf<1>(a, nblocks, stream);
  }
}

template <int NFW, int KC, int WN, int HC>
cudaError_t launch_coarse_hc(const Args& a, dim3 grid, cudaStream_t stream) {
  return launch_smem(miseg_k4_conv_coarse<NFW, KC, WN, HC>, grid, kBoxThreads,
                     a.smem_main + 2 * (size_t)a.wcin * sizeof(float), a, stream);
}

template <int NFW, int KC, int WN>
cudaError_t launch_coarse_wn(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  if (p.hc == 8) return launch_coarse_hc<NFW, KC, WN, 8>(a, grid, stream);
  if (p.hc == 4) return launch_coarse_hc<NFW, KC, WN, 4>(a, grid, stream);
  return launch_coarse_hc<NFW, KC, WN, kWholeChunks>(a, grid, stream);
}

template <int NFW, int KC>
cudaError_t launch_coarse_kc(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  return p.wn == 2 ? launch_coarse_wn<NFW, KC, 2>(a, grid, p, stream)
                   : launch_coarse_wn<NFW, KC, 1>(a, grid, p, stream);
}

template <int NFW>
cudaError_t launch_coarse_nfw(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  return p.kc == 32 ? launch_coarse_kc<NFW, 32>(a, grid, p, stream)
                    : launch_coarse_kc<NFW, 16>(a, grid, p, stream);
}

cudaError_t launch_coarse(const Args& a, dim3 grid, const Plan& p, cudaStream_t stream) {
  switch (p.nfw) {
    case 4: return launch_coarse_nfw<4>(a, grid, p, stream);
    case 3: return launch_coarse_nfw<3>(a, grid, p, stream);
    case 2: return launch_coarse_nfw<2>(a, grid, p, stream);
    default: return launch_coarse_nfw<1>(a, grid, p, stream);
  }
}

template <typename T, int BN>
cudaError_t launch_fma_bn(const Args& a, dim3 grid, cudaStream_t stream) {
  miseg_k4_conv_fma<T, BN><<<grid, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  miseg_k4_splitk_reduce<T, BN><<<dim3(grid.x, grid.y), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const Args& a, dim3 grid, int bn, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch_fma_bn<T, 16>(a, grid, stream);
    case 32: return launch_fma_bn<T, 32>(a, grid, stream);
    default: return launch_fma_bn<T, 64>(a, grid, stream);
  }
}

}  // namespace

// Voxels per statistics tile of a call of this shape: the fold needs it to
// weigh the partials.
extern "C" int miseg_fused_conv3_tile_voxels(int Z, int Y, int X, int cin, int cout,
                                             int dtype) {
  return plan_call(dtype, 1, Z, Y, X, cin, cout).tile;
}

// The widths [wcin, wcout] of the packed weights a call takes: cin and
// cout, or on the tensor-core paths each padded up to a multiple of 16
// (rows ci >= cin and columns co >= cout zero).
extern "C" void miseg_fused_conv3_weight_widths(int Z, int Y, int X, int cin, int cout,
                                                int dtype, int* widths) {
  const Plan p = plan_call(dtype, 1, Z, Y, X, cin, cout);
  widths[0] = p.wcin;
  widths[1] = p.wcout;
}

// How many K splits a call on this device makes; above 1 the caller passes
// a workspace of splits * B * ceil(Z*Y*X / tile voxels) * tile voxels *
// wcout floats (see miseg_fused_conv3_weight_widths).  The brick path
// never splits.
extern "C" int miseg_fused_conv3_splits(int B, int Z, int Y, int X, int cin,
                                        int cout, int dtype) {
  return plan_call(dtype, B, Z, Y, X, cin, cout).splits;
}

// How many arrival counters a call needs (0: none): a split call on the
// coarse path takes a power of two >= its splits per (tile, output-channel
// block), all 0 on entry and all 0 again when the launch ends.
extern "C" int miseg_fused_conv3_counters(int B, int Z, int Y, int X, int cin,
                                          int cout, int dtype) {
  const Plan p = plan_call(dtype, B, Z, Y, X, cin, cout);
  if (p.path != Path::coarse || p.splits == 1) return 0;
  return (int)((long long)B * Z * Y * X / p.tile * p.nblocks * p.tree);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it).  x is a
// contiguous [B, Z, Y, X, cin]; w a contiguous [3, 3, 3, wcin, wcout] (see
// miseg_fused_conv3_weight_widths);
// scale/shift contiguous f32 [B, cin], both null for no affine; leaky != 0
// applies the slope after the affine.  y is a contiguous [B, Z, Y, X,
// cout]; part is f32 [2, B * n_tiles, cout] with n_tiles = ceil(Z*Y*X /
// tile voxels) (see miseg_fused_conv3_tile_voxels); work is the split-K
// workspace (see miseg_fused_conv3_splits) or null when there is one
// split; counters the arrival counters (see miseg_fused_conv3_counters) or
// null when none are needed.  Calls that share counters run on one stream.
// halo: 0 for a whole volume; else the D-halo mode (see the header), x
// [B, Z + 2, Y, X, cin], with bit 1 set when x's first plane is the
// volume's zero padding and bit 2 when its last plane is.  Z, the plans and
// the partials are the output's.
// Returns the CUDA error code of the last launch (0 on success).
extern "C" int miseg_fused_conv3(const void* x, const void* w, const void* scale,
                                 const void* shift, float slope, int leaky,
                                 void* y, void* part, void* work, void* counters,
                                 int B, int Z, int Y, int X, int cin, int cout,
                                 int dtype, int halo, void* stream) {
  const long long s = (long long)Z * Y * X;
  const int zoff = halo ? 1 : 0;
  const long long sx = (long long)(Z + 2 * zoff) * Y * X;
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || cin < 1 || cout < 1 ||
      sx * (cin > cout ? cin : cout) >= (1LL << 31) || halo < 0 || halo > 7 ||
      (halo != 0 && !(halo & 1)) ||
      (scale == nullptr) != (shift == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.slope = slope;
  a.leaky = leaky;
  a.y = y;
  a.part = static_cast<float*>(part);
  a.work = static_cast<float*>(work);
  a.counters = static_cast<int*>(counters);
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.cin = cin;
  a.cout = cout;
  a.S = (int)s;
  a.Sx = (int)sx;
  a.zoff = zoff;
  a.zlo = (halo & 1) && !(halo & 2) ? -1 : 0;
  a.zhi = (halo & 1) && !(halo & 4) ? Z + 1 : Z;
  const Plan p = plan_call(dtype, B, Z, Y, X, cin, cout);
  a.wcin = p.wcin;
  a.wcout = p.wcout;
  a.n_tiles = (int)((s + p.tile - 1) / p.tile);
  a.n_parts = (long long)B * a.n_tiles;
  a.nsteps = p.nsteps;
  a.splits = p.splits;
  a.tz = p.tz;
  a.ty = p.ty;
  a.tx = p.tx;
  a.smem_main = p.smem_main;
  a.tree = p.tree;
  if (a.splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)a.n_parts, p.nblocks, a.splits);
  if (p.path == Path::cin1) return (int)launch_cin1(a, p.nblocks, st);
  if (p.path == Path::brick) return (int)launch_brick(a, grid, p, st);
  if (p.path == Path::coarse) {   // the splits add up inside the launch
    if (a.splits > 1 && counters == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_coarse(a, grid, p, st);
  }
  return (int)(dtype == 0 ? launch_fma<float>(a, grid, p.bn, st)
                          : launch_fma<__nv_bfloat16>(a, grid, p.bn, st));
}
