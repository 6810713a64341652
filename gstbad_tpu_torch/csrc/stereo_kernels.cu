// One path of semi-global matching's cost aggregation
// (gstbad_tpu_torch/ops/stereo.py sgm_aggregate): L = C + min(L, L(d-1) +
// P1, L(d+1) + P1, min L + P2) - min L walked along every scan line of a
// [B, H, W, D] float32 cost volume, added into `total` in place.  It
// replaces the JAX package's lax.scan over rows or columns
// (gstbad_tpu/ops/stereo.py:136-158), not a TPU kernel.
//
// One warp a scan line: lane l holds disparities l and l + 32, so a step
// reads one 256-byte row of costs, coalesced, and a shuffle reduction
// gives min L.  The walk is serial along the line (H or W steps), so a
// launch is bound by the chain of steps times the latency of one (a load,
// the reduction's five shuffles and a few float ops) unless enough lines
// run at once to reach the memory rate: each step reads C and `total` and
// writes `total`.  Every value is an integer under 2^24, so the sums are
// exact and equal the plain walk's.  The diagonal passes read the JAX
// package's jnp.roll-sheared volume: position (i, j) of the sheared volume
// is column (j - shear * i) mod W of row i, and the pass's result goes
// back to the same place.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void sgm_aggregate_kernel(const float* cost, float* total, int b,
                                     int h, int w, int d, int axis,
                                     int reverse, int shear, float p1,
                                     float p2) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lines = axis == 0 ? w : h;
  if (warp >= b * lines) return;
  const int f = warp / lines;
  const int line = warp % lines;
  const int n = axis == 0 ? h : w;
  const size_t plane = static_cast<size_t>(h) * w * d;
  const float* C = cost + f * plane;
  float* T = total + f * plane;
  const int d0 = lane, d1 = lane + 32;
  float prev0 = CUDART_INF_F, prev1 = CUDART_INF_F;
  for (int k = 0; k < n; ++k) {
    const int s = reverse ? n - 1 - k : k;
    int row, col;
    if (axis == 0) {
      row = s;
      col = line;
      if (shear) col = ((line - shear * row) % w + w) % w;
    } else {
      row = line;
      col = s;
    }
    const size_t at = (static_cast<size_t>(row) * w + col) * d;
    const float c0 = d0 < d ? C[at + d0] : CUDART_INF_F;
    const float c1 = d1 < d ? C[at + d1] : CUDART_INF_F;
    float l0, l1;
    if (k == 0) {
      l0 = c0;
      l1 = c1;
    } else {
      float m = fminf(prev0, prev1);
      for (int o = 16; o > 0; o >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
      // neighbours: d - 1 and d + 1 (infinite past either end)
      float lo0 = __shfl_up_sync(0xffffffffu, prev0, 1);
      float lo1 = __shfl_up_sync(0xffffffffu, prev1, 1);
      const float top0 = __shfl_sync(0xffffffffu, prev0, 31);
      if (lane == 0) {
        lo0 = CUDART_INF_F;
        lo1 = top0;
      }
      float hi0 = __shfl_down_sync(0xffffffffu, prev0, 1);
      float hi1 = __shfl_down_sync(0xffffffffu, prev1, 1);
      const float bot1 = __shfl_sync(0xffffffffu, prev1, 0);
      if (lane == 31) {
        hi0 = bot1;
        hi1 = CUDART_INF_F;
      }
      if (d0 + 1 >= d) hi0 = CUDART_INF_F;
      if (d1 + 1 >= d) hi1 = CUDART_INF_F;
      const float mp2 = __fadd_rn(m, p2);
      const float b0 = fminf(fminf(prev0, __fadd_rn(lo0, p1)),
                             fminf(__fadd_rn(hi0, p1), mp2));
      const float b1 = fminf(fminf(prev1, __fadd_rn(lo1, p1)),
                             fminf(__fadd_rn(hi1, p1), mp2));
      l0 = __fsub_rn(__fadd_rn(c0, b0), m);
      l1 = __fsub_rn(__fadd_rn(c1, b1), m);
    }
    if (d0 < d) T[at + d0] = __fadd_rn(T[at + d0], l0);
    if (d1 < d) T[at + d1] = __fadd_rn(T[at + d1], l1);
    prev0 = d0 < d ? l0 : CUDART_INF_F;
    prev1 = d1 < d ? l1 : CUDART_INF_F;
  }
}

// The latency of one step of the walk: one warp runs `steps` steps on
// registers (the min reduction's five shuffles, the neighbours' four, the
// float ops) and reports the clock cycles they took.  Used for
// sgm_aggregate's chain bound.
__global__ void sgm_cycles_kernel(long long* out, int steps) {
  const int lane = threadIdx.x;
  float prev0 = lane * 3.0f, prev1 = lane * 5.0f + 1.0f;
  const long long t0 = clock64();
  for (int k = 0; k < steps; ++k) {
    float m = fminf(prev0, prev1);
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float lo0 = __shfl_up_sync(0xffffffffu, prev0, 1);
    const float lo1 = __shfl_up_sync(0xffffffffu, prev1, 1);
    const float hi0 = __shfl_down_sync(0xffffffffu, prev0, 1);
    const float hi1 = __shfl_down_sync(0xffffffffu, prev1, 1);
    const float mp2 = __fadd_rn(m, 255.0f);
    const float b0 = fminf(fminf(prev0, __fadd_rn(lo0, 200.0f)),
                           fminf(__fadd_rn(hi0, 200.0f), mp2));
    const float b1 = fminf(fminf(prev1, __fadd_rn(lo1, 200.0f)),
                           fminf(__fadd_rn(hi1, 200.0f), mp2));
    prev0 = __fsub_rn(__fadd_rn(static_cast<float>(k & 63), b0), m);
    prev1 = __fsub_rn(__fadd_rn(static_cast<float>(k & 31), b1), m);
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(prev0 + prev1);
  }
}

}  // namespace

extern "C" int gst_sgm_step_cycles(void* out, int steps, void* stream) {
  sgm_cycles_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_sgm_aggregate(const void* cost, void* total, int b, int h,
                                 int w, int d, int axis, int reverse,
                                 int shear, int p1, int p2, void* stream) {
  if (d < 1 || d > 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(b) * (axis == 0 ? w : h);
  if (warps <= 0) return 0;
  const int threads = 128;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  sgm_aggregate_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<float*>(total), b, h, w, d,
      axis, reverse, shear, static_cast<float>(p1), static_cast<float>(p2));
  return static_cast<int>(cudaGetLastError());
}
