// Hand-written Hopper kernel of the gaussianblur element
// (gstbad_tpu_torch/ops/blur.py).  Plain C entry point, loaded with ctypes
// by gstbad_tpu_torch/ops/_cuda.py; it launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so blur_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K3: separable gaussian blur of packed AYUV words, all four channels.
//
// Replaces gstbad_tpu/ops/blur_pallas.py:_kernel.  Per channel: the x pass
// (taps k = 0 .. 2c over columns, out-of-frame taps 0.0) divided by the
// column's border sum, then the y pass over rows divided by the row's
// border sum, +0.5, clamp to [0, 255], truncate (gaussian_smooth,
// gstgaussblur.c:260-356).  The float32 operation order is the plain
// version's (ops/blur.py:_blur_plane) and the TPU kernel's: each tap is a
// rounded product, added in tap order (no contraction of a product into
// the sum), and each quotient is the correctly rounded one.  So the result
// is bit-exact against the plain version.  Two exact rewrites keep that
// order with fewer instructions:
// - an x-pass product takes one FFMA: a byte b becomes f = 2^23 + b by a
//   byte permute (its float bits are 0x4B0000bb), and fma(f, t, -2^23 t)
//   is b t rounded once, the rounded product RN(b t).
// - a quotient a / b is Markstein's: with y = RN(1/b) (computed once per
//   column and row of a tile by __frcp_rn), q0 = RN(a y), then twice
//   r = fma(-q, b, a), q = fma(r, y, q).  The first correction leaves q
//   within one ulp of a/b, and from a faithful q one more gives RN(a/b)
//   (Markstein's theorem), as long as no step leaves the normal range.
//   Each block checks that its taps and sums keep it there (see
//   in_range); a block whose table does not (frames narrower than the
//   window, whose border sums can be 0 or negative, or |sigma| < 0.18,
//   whose side taps are tiny) takes __fdiv_rn.  Markstein's form is one
//   FMUL and four FFMA in the SASS, where __fdiv_rn takes a reciprocal,
//   its Newton step, a range check and a branch to a slow path.
//
// Bound: by operations, on the FP32 pipe (one FMUL, FADD or FFMA a lane a
// clock, 128 lanes an SM).  Per channel and pixel of each distinct source
// frame the least is 2 (2c + 1) products and 2 (2c + 1) - 2 sums over the
// two passes (the first product starts each sum), the two divisions (one
// FMUL and four FFMA each) and 2 more (the +0.5, and the saturating
// conversion that is also the clamp): 46 at the main path's 9 taps.  The
// bytes are one read of the source word and one write of the output word.
// A broadcast source (a [1, H, W] base for B frames, a static videotestsrc
// frame) has one frame to compute: the block blurs its tile once and
// stores it to all B frames, so that case is bound by the output's bytes.
//
// Design: one block of 288 threads per 64-column tile.  The host picks the
// tile's height (64, 32, 16 or 8 rows) that keeps the most output rows in
// flight: blocks an SM by shared memory, at most three, times the output
// rows' share of the staged rows (blur_tile_height).  The block stages its
// source words plus a c-pixel halo on every side with 4-byte cp.async,
// whose zero fill gives the out-of-frame 0.0 exactly, and then runs the
// two channel pairs (bytes 0-1, then 2-3) in turn: the x pass into a
// float2 tile, one barrier, the y pass.  A pair's x-pass items are (staged
// row, run of 8 columns): 576 at the main path's centre 4 and 64-row
// tile, two a thread.  An item unpacks each staged word once for both
// channels and keeps eight outputs per channel in registers with a ring of
// the last eight inputs; the x tile's odd row pitch keeps a warp's stores,
// one row a lane, on distinct banks.  The y pass's items are (column, run
// of 8 rows) with the same ring over the x tile; the first pair parks its
// two output bytes in shared memory, the second packs the words and stores
// them.  At the main path's centre (kBlurFixedCenter) the tap count is a
// compile-time constant and the taps unroll completely; any other centre
// runs its taps in groups of eight with no branch inside a group (run_taps).
// Two channels a pass (where one pass of all four held 127 registers and
// one block an SM) and the launch bound of three blocks an SM (72
// registers) keep up to 27 warps on an SM.  A 64-row tile recomputes 2c
// halo rows in the x pass (12% at c = 4).  What holds it at 1.74 ms on a
// materialized 1080p window of 64 frames (H100 80GB HBM3, 700 W) is not
// measured: the least FP32 work, 0.73 ms, is 42% of that time, and the
// staging and the barriers overlap the other blocks' arithmetic only in
// part.
// The halo is the kernel's centre, up to 50 (|sigma| <= 20); any H and W
// are handled by masking the ragged tile.
// ---------------------------------------------------------------------------

constexpr int kBlurTileW = 64;       // output columns per block
constexpr int kRun = 8;              // outputs per item in each pass
constexpr int kRunsPerRow = kBlurTileW / kRun;
constexpr int kBlurMaxCenter = 50;   // ceil(2.5 * 20)
constexpr int kBlurMaxTaps = 2 * kBlurMaxCenter + 1;
// the centre of sigma 1.2 (ceil(2.5 sigma) in float32), the element's
// default (gstgaussblur.c DEFAULT_SIGMA) and the cells': its taps are a
// compile-time count and unroll completely
constexpr int kBlurFixedCenter = 4;
// 4 (64 + 2 * 4): two x-pass items a thread at the fixed centre; three
// blocks an SM leave each thread 72 registers
constexpr int kBlurThreads = 288;
constexpr int kBlurBlocksPerSm = 3;
constexpr int kXPitch = kBlurTileW + 1;   // float2 x-tile row pitch, odd
constexpr float kTwo23 = 8388608.0f;
// shared memory: 228 KB an SM, 1 KB of it reserved a block, 227 KB at most
// a block
constexpr size_t kSmemPerSm = 228 * 1024;
constexpr size_t kSmemPerBlock = 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int staged_pitch(int center) {
  return (kBlurTileW + 2 * center) | 1;   // odd: conflict-free row walks
}

size_t blur_smem_bytes(int th, int center) {
  const size_t sh = th + 2 * center;
  // x tile of one channel pair (float2), taps (t, -2^23 t), column and row
  // (sum, 1/sum), the first pair's output bytes, staged words
  return sizeof(float2) * (sh * kXPitch + kBlurMaxTaps + kBlurTileW + th) +
         sizeof(uint16_t) * th * kBlurTileW +
         sizeof(int32_t) * sh * staged_pitch(center);
}

// the tile height (64, 32, 16 or 8 rows) that keeps the most output rows
// in flight on an SM: its blocks (by shared memory, at most three) times
// the output rows' share of the x pass's staged rows, th / (th + 2c).
// 64 rows at centres up to 7 and from 36, 32 from 8 to 35; 0 if none fits
int blur_tile_height(int center) {
  int best = 0;
  double best_rows = 0.0;
  for (int th = 64; th >= kRun; th /= 2) {
    const size_t smem = blur_smem_bytes(th, center);
    if (smem > kMaxSmem) continue;
    size_t blocks = kSmemPerSm / (smem + kSmemPerBlock);
    if (blocks > kBlurBlocksPerSm) blocks = kBlurBlocksPerSm;
    const double rows =
        static_cast<double>(blocks) * th / (th + 2 * center);
    if (rows > best_rows) {
      best = th;
      best_rows = rows;
    }
  }
  return best;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// RN(a / b): IEEE division, or Markstein's two corrections from
// y = RN(1 / b) where the block's taps and sums keep every step normal
template <bool kIeee>
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  if (kIeee) return __fdiv_rn(a, b);
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-q, b, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, y, q);
}

template <bool kIeee>
__device__ __forceinline__ float2 div2(float2 a, float2 by) {
  return make_float2(div_rn<kIeee>(a.x, by.x, by.y),
                     div_rn<kIeee>(a.y, by.x, by.y));
}

// Markstein's quotient is RN(a/b) when no step leaves the normal range.
// Nonzero taps of magnitude in [2^-22, 2^22] make every nonzero x-pass sum
// a multiple of 2^-45, and sums in [2^-8, 2^8] then every nonzero y-pass
// sum at least 2^-98, so each remainder is exact and no step underflows
// or overflows.  Zero, negative and tiny border sums (frames narrower than
// the window) and the tiny side taps of |sigma| < 0.18 fall outside.
__device__ __forceinline__ bool in_range(float v, float lo, float hi) {
  const float m = fabsf(v);
  return m >= lo && m <= hi;
}

// x pass: RN(b t) from f = 2^23 + b and (t, -2^23 t)
__device__ __forceinline__ float2 mul_x(float2 f, float2 t) {
  return make_float2(__fmaf_rn(f.x, t.x, t.y), __fmaf_rn(f.y, t.x, t.y));
}

// y pass: RN(v t)
__device__ __forceinline__ float2 mul_y(float2 v, float2 t) {
  return make_float2(__fmul_rn(v.x, t.x), __fmul_rn(v.y, t.x));
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// acc[i] = sum over k of mul(v(i + k), tap k) from 0.0 in tap order,
// v(j) = load(j).  A ring holds the last eight inputs: after tap k its
// input v(k) is done with, and the slot takes v(k + 8).  The taps go in
// groups of 8, so every ring index is a compile-time register.  With a
// fixed tap count (kFixed) every group unrolls, and the first product
// starts each sum: 0.0 + p is p, but for the sign of a zero sum, which no
// later step can tell (a quotient of +-0 is +-0, and +-0 + 0.5 rounds to
// the same byte).  With a runtime count the whole groups run in a loop of
// one body with no branch between its taps, and only the last group
// checks each tap against the count.
template <bool kFixed, typename Mul, typename Load>
__device__ __forceinline__ void run_taps(float2 (&acc)[kRun],
                                         const float2* s_tap, int taps,
                                         Mul mul, Load load) {
  float2 ring[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    ring[i] = load(i);
    if (!kFixed) acc[i] = make_float2(0.0f, 0.0f);
  }
  auto group = [&](int k0, bool whole) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int k = k0 + j;
      if (whole || k < taps) {
        const float2 t = s_tap[k];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const float2 p = mul(ring[(i + j) % kRun], t);
          acc[i] = kFixed && k == 0 ? p : add2(acc[i], p);
        }
        if (whole || k + 1 < taps) ring[j] = load(k + kRun);
      }
    }
  };
  if (kFixed) {
#pragma unroll
    for (int k0 = 0; k0 < taps; k0 += kRun) group(k0, false);
  } else {
    int k0 = 0;
#pragma unroll 1
    for (; k0 + kRun < taps; k0 += kRun) group(k0, true);
    group(k0, false);
  }
}

// trunc(clamp(q + 0.5, 0, 255)): a float-to-u8 conversion rounds toward
// zero and saturates (a NaN gives 0, as the clamp of fminf/fmaxf does)
__device__ __forceinline__ uint32_t to_byte(float q) {
  const float v = __fadd_rn(q, 0.5f);
  unsigned short b;
  asm("cvt.rzi.u8.f32 %0, %1;" : "=h"(b) : "f"(v));
  return b;
}

struct BlurTile {
  float2* x;            // x values of one channel pair
  const float2* tap;    // (t, -2^23 t)
  const float2* col;    // (sum, 1 / sum) of the tile's columns
  const float2* row;    // (sum, 1 / sum) of its rows
  uint16_t* half;       // the first pair's output bytes
  const int32_t* src;   // staged words
  int th, sh, sp, taps, c0, r0;
};

// the x pass and the y pass of channel pair `pair` (bytes 2 pair and
// 2 pair + 1); the second pair stores the output words
template <bool kIeee, int kC>
__device__ __forceinline__ void blur_pair(const BlurTile& t, int pair,
                                          int32_t* __restrict__ out, int B,
                                          int H, int W, int bcast) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int taps = kC ? 2 * kC + 1 : t.taps;
  // x pass: item = (staged row, run of 8 columns); a warp walks rows
  const uint32_t sel0 = 0x7440u + 2 * pair, sel1 = sel0 + 1;
  for (int item = tid; item < t.sh * kRunsPerRow; item += nt) {
    const int rr = item % t.sh, cx = (item / t.sh) * kRun;
    const int32_t* row = t.src + rr * t.sp + cx;
    float2 acc[kRun];
    run_taps<kC != 0>(
        acc, t.tap, taps, [](float2 f, float2 k) { return mul_x(f, k); },
        [&](int j) {   // f = 2^23 + byte: float bits 0x4B0000bb
          const uint32_t u = static_cast<uint32_t>(row[j]);
          return make_float2(
              __uint_as_float(__byte_perm(u, 0x4B000000u, sel0)),
              __uint_as_float(__byte_perm(u, 0x4B000000u, sel1)));
        });
    // rows outside the frame are the y pass's zero padding: 0 / b is 0,
    // but where a border sum is 0 (the IEEE path) it would be NaN
    const bool in_frame = !kIeee || static_cast<unsigned>(
        t.r0 - taps / 2 + rr) < static_cast<unsigned>(H);
    float2* dst = t.x + rr * kXPitch + cx;
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      dst[i] = in_frame ? div2<kIeee>(acc[i], t.col[cx + i])
                        : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // y pass: item = (column, run of 8 rows); a warp walks columns
  const size_t plane = static_cast<size_t>(H) * W;
  for (int item = tid; item < kRunsPerRow * t.th; item += nt) {
    const int tx = item % kBlurTileW, ty0 = (item / kBlurTileW) * kRun;
    const float2* col = t.x + ty0 * kXPitch + tx;
    float2 acc[kRun];
    run_taps<kC != 0>(acc, t.tap, taps,
                      [](float2 v, float2 k) { return mul_y(v, k); },
                      [&](int j) { return col[j * kXPitch]; });
    uint16_t* half = t.half + ty0 * kBlurTileW + tx;
    uint32_t word[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const float2 q = div2<kIeee>(acc[i], t.row[ty0 + i]);
      const uint32_t two = __byte_perm(to_byte(q.x), to_byte(q.y), 0x0040);
      if (pair == 0)
        half[i * kBlurTileW] = static_cast<uint16_t>(two);
      else
        word[i] = __byte_perm(half[i * kBlurTileW], two, 0x5410);
    }
    const int gc = t.c0 + tx;
    if (pair == 0 || gc >= W) continue;
    // a broadcast tile is stored to every frame, a materialized one to its
    // own
    const int f0 = bcast ? 0 : blockIdx.z, f1 = bcast ? B : blockIdx.z + 1;
    for (int f = f0; f < f1; ++f) {
      int32_t* o = out + plane * f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const int gr = t.r0 + ty0 + i;
        if (gr < H)
          o[static_cast<size_t>(gr) * W + gc] = static_cast<int32_t>(word[i]);
      }
    }
  }
}

template <bool kIeee, int kC>
__device__ __forceinline__ void blur_pairs(const BlurTile& t,
                                           int32_t* __restrict__ out, int B,
                                           int H, int W, int bcast) {
  // one copy of the passes for both pairs (a second copy would crowd the
  // instruction cache)
#pragma unroll 1
  for (int pair = 0; pair < 2; ++pair) {
    if (pair == 1) __syncthreads();   // the first pair's x tile is read
    blur_pair<kIeee, kC>(t, pair, out, B, H, W, bcast);
  }
}

// kC: the centre as a constant (kBlurFixedCenter), or 0 for any centre.
// Three blocks an SM, where shared memory allows, so that one block's
// staging and barriers overlap the others' arithmetic.
template <int kC>
__global__ void __launch_bounds__(kBlurThreads, kBlurBlocksPerSm)
blur_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
            const float* __restrict__ kern,
            const float* __restrict__ row_sums,
            const float* __restrict__ col_sums, int B, int H, int W,
            int center, int th, int bcast) {
  extern __shared__ float2 smem[];
  BlurTile t;
  t.th = th;
  t.taps = 2 * center + 1;
  t.sh = th + 2 * center;                   // staged rows
  const int sw = kBlurTileW + 2 * center;   // staged columns
  t.sp = staged_pitch(center);
  t.c0 = blockIdx.x * kBlurTileW;
  t.r0 = blockIdx.y * th;
  float2* s_x = smem;
  float2* s_tap = s_x + t.sh * kXPitch;
  float2* s_col = s_tap + kBlurMaxTaps;
  float2* s_row = s_col + kBlurTileW;
  uint16_t* s_half = reinterpret_cast<uint16_t*>(s_row + th);
  int32_t* s_src = reinterpret_cast<int32_t*>(s_half + th * kBlurTileW);
  t.x = s_x;
  t.tap = s_tap;
  t.col = s_col;
  t.row = s_row;
  t.half = s_half;
  t.src = s_src;

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const int32_t* s = src + (bcast ? 0 : plane * blockIdx.z);

  // stage: each warp takes rows, its lanes neighbouring columns
  for (int rr = tid / 32; rr < t.sh; rr += nt / 32) {
    const int gr = t.r0 - center + rr;
    const bool row_ok = gr >= 0 && gr < H;
    const int32_t* line = s + static_cast<size_t>(row_ok ? gr : 0) * W;
    for (int cc = tid % 32; cc < sw; cc += 32) {
      const int gc = t.c0 - center + cc;
      const bool ok = row_ok && gc >= 0 && gc < W;
      cp_async4(s_src + rr * t.sp + cc, line + (ok ? gc : 0), ok);
    }
  }
  bool unsafe = false;   // for Markstein's quotient
  for (int i = tid; i < t.taps; i += nt) {
    const float k = kern[i];
    s_tap[i] = make_float2(k, -kTwo23 * k);
    unsafe |= k != 0.0f && !in_range(k, 0x1p-22f, 0x1p22f);
  }
  for (int i = tid; i < kBlurTileW + th; i += nt) {
    const bool is_col = i < kBlurTileW;
    const int g = is_col ? t.c0 + i : t.r0 + i - kBlurTileW;
    const bool ok = is_col ? g < W : g < H;
    const float b = ok ? (is_col ? col_sums : row_sums)[g] : 1.0f;
    s_col[i] = make_float2(b, __frcp_rn(b));   // s_row follows s_col
    unsafe |= !in_range(b, 0x1p-8f, 0x1p8f);
  }
  cp_async_wait_all();
  if (__syncthreads_or(unsafe))
    blur_pairs<true, kC>(t, out, B, H, W, bcast);
  else
    blur_pairs<false, kC>(t, out, B, H, W, bcast);
}

}  // namespace

template <int kC>
cudaError_t launch_blur(const dim3& grid, size_t smem,
                        cudaStream_t stream, const void* src, void* out,
                        const void* kern, const void* row_sums,
                        const void* col_sums, int B, int H, int W, int center,
                        int th, int bcast) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  blur_kernel<kC><<<grid, kBlurThreads, smem, stream>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
      static_cast<const float*>(kern), static_cast<const float*>(row_sums),
      static_cast<const float*>(col_sums), B, H, W, center, th, bcast);
  return cudaGetLastError();
}

extern "C" int gst_gaussian_blur(const void* src, void* out,
                                 const void* kern, const void* row_sums,
                                 const void* col_sums, int B, int H, int W,
                                 int center, int bcast, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (center < 0 || center > kBlurMaxCenter)
    return static_cast<int>(cudaErrorInvalidValue);
  const int th = blur_tile_height(center);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kBlurTileW - 1) / kBlurTileW, (H + th - 1) / th,
                  bcast ? 1 : B);
  const size_t smem = blur_smem_bytes(th, center);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      center == kBlurFixedCenter
          ? launch_blur<kBlurFixedCenter>(grid, smem, st, src, out, kern,
                                          row_sums, col_sums, B, H, W,
                                          center, th, bcast)
          : launch_blur<0>(grid, smem, st, src, out, kern, row_sums,
                           col_sums, B, H, W, center, th, bcast));
}
