// Hand-written Hopper kernel of the geometric warps
// (gstbad_tpu_torch/ops/remap.py, elements/geometry/).  Plain C entry
// point, loaded with ctypes by gstbad_tpu_torch/ops/_cuda.py; it launches on
// the stream it is given, allocates nothing, and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so warp_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K7: nearest-neighbour remap of packed 4-byte pixels through a static
// inverse map, with the off-edge background:
//   out[b, p] = 0 <= map[p] < H*W ? src[b, map[p]] : bg
//
// Replaces gstbad_tpu/ops/warp_pallas.py:_kernel.  The map is fixed once
// on the host (ops/remap.py:fix_map, the reference's precalc_map and
// truncation sampling, gstgeometrictransform.c:80-207) and an off-edge
// pixel is encoded as -1, so one int32 array carries both the index and
// the validity.  The TPU kernel's tile-class planner, transposed sub-plan,
// identity-tile select and scatter fix-up existed because a TPU core has
// no per-lane gather from memory; a GPU thread has one, so none of them is
// carried over.
//
// Bound: device memory.  The minimum traffic is the map read once, each
// source frame read once and each output frame written once.  Design: one
// thread per output pixel and a run of up to 8 frames (grid.y walks the
// runs), so the map entry is read once per run and the 8 gathers are in
// flight together.  Neighbouring threads write neighbouring words, so the
// stores are coalesced; the gathers follow a smooth map, so a warp's reads
// fall on a few nearby source lines and are served by L1/L2.  A broadcast
// source ([1, H, W], a static videotestsrc frame) is gathered once per
// pixel and stored to every frame of the run.
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 256;
constexpr int kWarpFrames = 8;     // frames per thread

__global__ void __launch_bounds__(kWarpThreads)
warp_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ out,
            const int32_t* __restrict__ map, long long hw, int B, int bg,
            int bcast) {
  const long long p =
      static_cast<long long>(blockIdx.x) * kWarpThreads + threadIdx.x;
  if (p >= hw) return;
  const int m = map[p];
  const bool valid = m >= 0 && m < hw;
  const int f0 = blockIdx.y * kWarpFrames;
  int32_t v[kWarpFrames];
  if (bcast) {
    const int32_t w = valid ? __ldg(src + m) : bg;
#pragma unroll
    for (int i = 0; i < kWarpFrames; ++i) v[i] = w;
  } else {
#pragma unroll
    for (int i = 0; i < kWarpFrames; ++i) {
      const int f = f0 + i;
      v[i] = (valid && f < B) ? __ldg(src + hw * f + m) : bg;
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpFrames; ++i) {
    const int f = f0 + i;
    if (f < B) out[hw * f + p] = v[i];
  }
}

}  // namespace

extern "C" int gst_warp_words(const void* src, void* out, const void* map,
                              int B, int H, int W, int bg, int bcast,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const long long hw = static_cast<long long>(H) * W;
  const dim3 grid(static_cast<unsigned>((hw + kWarpThreads - 1) /
                                        kWarpThreads),
                  (B + kWarpFrames - 1) / kWarpFrames);
  warp_kernel<<<grid, kWarpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(map), hw, B, bg, bcast);
  return static_cast<int>(cudaGetLastError());
}
