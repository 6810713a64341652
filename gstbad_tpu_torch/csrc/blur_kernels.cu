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
// rounded product then a rounded sum from 0.0 (__fmul_rn / __fadd_rn, so
// nvcc cannot contract them into an FMA), and the divisions are IEEE
// (__fdiv_rn).  So the result is bit-exact against the plain version.
//
// Bound: by operations on a materialized window.  Per output pixel and
// channel the two passes take 2 (2c + 1) multiplies and adds and two IEEE
// divisions; the bytes are one read of the source word and one write of
// the output word.  A broadcast source (a [1, H, W] base for B frames, a
// static videotestsrc frame) has one frame to compute: the block blurs its
// tile once and stores it to all B frames, so that case is bound by the
// output's bytes.
//
// Design: one block per 64 x 32 output tile (of one frame, or of the one
// broadcast frame).  The block stages its source words plus a c-pixel halo
// on every side in shared memory once (zeros outside the frame, which is
// what makes out-of-frame taps exactly 0.0).  Then per channel: the x pass
// over the 32 + 2c staged rows into a float tile divided by the column
// sums, and the y pass from that tile into the thread's eight output
// words.  Shared-memory loads, not arithmetic, limited a first version
// that loaded one value and one tap per multiply (3.96 ms for a
// materialized 1080p x 64 window at sigma 1.2 in chip_smoke.py, NVIDIA
// H100 80GB HBM3 at a 700 W power limit).  So each thread computes eight
// neighbouring outputs of a pass with a rolling window of eight values in
// registers: per tap it loads the tap and one new value for eight
// multiplies.  The window is a ring indexed by the tap number mod 8, with
// the taps unrolled by 8 so every ring index is a compile-time register.
// The x pass gives each thread eight columns of one staged row (the row
// pitch is odd, so the 32 rows a warp reads fall in 32 banks); the y pass
// eight rows of one column.  The halo is the kernel's centre, up to 50
// (|sigma| <= 20); the TPU kernel's 8-row halo limit (centre <= 8) and its
// (8, 128) alignment are gone, and any H and W are handled by masking the
// ragged tile.  Bytes become floats with an exact bit trick at full rate,
// float(b) = as_float(0x4B000000 | b) - 2^23, and trunc(v) for v in
// [0, 255] is the low byte of as_int(v + 2^23) added rounding toward zero.
// ---------------------------------------------------------------------------

constexpr int kBlurTileW = 64;       // output columns per block
constexpr int kBlurTileH = 32;       // output rows per block
constexpr int kBlurThreads = 256;
constexpr int kRun = 8;              // outputs per thread in each pass
constexpr int kBlurMaxCenter = 50;   // ceil(2.5 * 20)
constexpr int kBlurMaxTaps = 2 * kBlurMaxCenter + 1;
constexpr int kXPitch = kBlurTileW + 1;   // float x-pass tile row pitch
constexpr float kTwo23 = 8388608.0f;

__host__ __device__ constexpr int staged_pitch(int center) {
  return (kBlurTileW + 2 * center) | 1;   // odd: conflict-free row walks
}

size_t blur_smem_bytes(int center) {
  const size_t sh = kBlurTileH + 2 * center;
  // taps, column and row sums, staged words, x-pass tile
  return sizeof(float) * (kBlurMaxTaps + kBlurTileW + kBlurTileH +
                          sh * staged_pitch(center) + sh * kXPitch);
}

__device__ __forceinline__ float byte_to_float(int32_t word, int shift) {
  const uint32_t b = (static_cast<uint32_t>(word) >> shift) & 255u;
  return __fsub_rn(__uint_as_float(0x4B000000u | b), kTwo23);
}

// acc[i] = sum over k = 0 .. taps-1 of v(i + k) * s_k[k], each term a
// rounded product added in order from 0.0; v(j) = load(j) for j in
// [0, taps + kRun - 1).
template <typename Load>
__device__ __forceinline__ void run_taps(float (&acc)[kRun],
                                         const float* s_k, int taps,
                                         Load load) {
  float ring[kRun];   // ring[(i + k) % kRun] holds v(k + i) at tap k
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    ring[i] = load(i);
    acc[i] = 0.0f;
  }
  for (int k0 = 0; k0 < taps; k0 += kRun) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int k = k0 + j;
      if (k < taps) {
        const float kk = s_k[k];
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(ring[(i + j) % kRun], kk));
        // v(k) is done with; its slot takes v(k + kRun)
        if (k + 1 < taps) ring[j] = load(k + kRun);
      }
    }
  }
}

__global__ void __launch_bounds__(kBlurThreads)
blur_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
            const float* __restrict__ kern,
            const float* __restrict__ row_sums,
            const float* __restrict__ col_sums, int B, int H, int W,
            int center, int bcast) {
  extern __shared__ float smem[];
  const int taps = 2 * center + 1;
  const int sh = kBlurTileH + 2 * center;   // staged rows
  const int sw = kBlurTileW + 2 * center;   // staged columns
  const int sp = staged_pitch(center);
  float* s_k = smem;
  float* s_cs = s_k + kBlurMaxTaps;
  float* s_rs = s_cs + kBlurTileW;
  int32_t* s_src = reinterpret_cast<int32_t*>(s_rs + kBlurTileH);
  float* s_x = reinterpret_cast<float*>(s_src + sh * sp);

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kBlurTileW;
  const int r0 = blockIdx.y * kBlurTileH;
  const size_t plane = static_cast<size_t>(H) * W;
  const int32_t* s = src + (bcast ? 0 : plane * blockIdx.z);

  for (int i = tid; i < taps; i += kBlurThreads) s_k[i] = kern[i];
  if (tid < kBlurTileW)
    s_cs[tid] = c0 + tid < W ? col_sums[c0 + tid] : 1.0f;
  else if (tid < kBlurTileW + kBlurTileH)
    s_rs[tid - kBlurTileW] =
        r0 + tid - kBlurTileW < H ? row_sums[r0 + tid - kBlurTileW] : 1.0f;
  // stage: each warp takes rows, its lanes neighbouring columns
  for (int rr = tid / 32; rr < sh; rr += kBlurThreads / 32) {
    const int gr = r0 - center + rr;
    const bool row_ok = gr >= 0 && gr < H;
    const int32_t* line = s + static_cast<size_t>(row_ok ? gr : 0) * W;
    for (int cc = tid % 32; cc < sw; cc += 32) {
      const int gc = c0 - center + cc;
      s_src[rr * sp + cc] = (row_ok && gc >= 0 && gc < W) ? line[gc] : 0;
    }
  }

  const int tx = tid % kBlurTileW;           // y pass: column
  const int ty0 = (tid / kBlurTileW) * kRun;  // y pass: first of 8 rows
  uint32_t word[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) word[i] = 0;

  for (int ch = 0; ch < 4; ++ch) {
    const int shift = 8 * ch;
    __syncthreads();   // staged words ready; last channel's x tile read
    // x pass: item = (staged row, run of 8 columns); a warp walks rows
    for (int item = tid; item < sh * (kBlurTileW / kRun);
         item += kBlurThreads) {
      const int rr = item % sh, cx = (item / sh) * kRun;
      const int32_t* row = s_src + rr * sp + cx;
      float acc[kRun];
      run_taps(acc, s_k, taps,
               [&](int j) { return byte_to_float(row[j], shift); });
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        s_x[rr * kXPitch + cx + i] = __fdiv_rn(acc[i], s_cs[cx + i]);
    }
    __syncthreads();
    // y pass: rows ty0 .. ty0 + 7 of column tx
    float acc[kRun];
    const float* col = s_x + ty0 * kXPitch + tx;
    run_taps(acc, s_k, taps, [&](int j) { return col[j * kXPitch]; });
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      float v = __fadd_rn(__fdiv_rn(acc[i], s_rs[ty0 + i]), 0.5f);
      v = fminf(fmaxf(v, 0.0f), 255.0f);
      word[i] |= (__float_as_uint(__fadd_rz(v, kTwo23)) & 255u) << shift;
    }
  }
  const int gc = c0 + tx;
  if (gc >= W) return;
  // a broadcast tile is stored to every frame, a materialized one to its own
  const int f0 = bcast ? 0 : blockIdx.z, f1 = bcast ? B : blockIdx.z + 1;
  for (int f = f0; f < f1; ++f) {
    int32_t* o = out + plane * f;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int gr = r0 + ty0 + i;
      if (gr < H)
        o[static_cast<size_t>(gr) * W + gc] = static_cast<int32_t>(word[i]);
    }
  }
}

}  // namespace

extern "C" int gst_gaussian_blur(const void* src, void* out,
                                 const void* kern, const void* row_sums,
                                 const void* col_sums, int B, int H, int W,
                                 int center, int bcast, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (center < 0 || center > kBlurMaxCenter)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(blur_smem_bytes(kBlurMaxCenter)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((W + kBlurTileW - 1) / kBlurTileW,
                  (H + kBlurTileH - 1) / kBlurTileH, bcast ? 1 : B);
  blur_kernel<<<grid, kBlurThreads, blur_smem_bytes(center),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
      static_cast<const float*>(kern), static_cast<const float*>(row_sums),
      static_cast<const float*>(col_sums), B, H, W, center, bcast);
  return static_cast<int>(cudaGetLastError());
}
