// Haar cascade evaluation (gstbad_tpu_torch/ops/haar.py): H1 walks one
// pyramid scale of a window of frames, H2 builds OpenCV's rotated
// summed-area table.  Neither replaces a TPU kernel: they replace the JAX
// package's scan over a face cascade's ~1050 trees
// (gstbad_tpu/ops/haar.py:343-375), its node-by-node unrolled hand
// cascades (:130-190) and its row scan of the rotated table (:72-101),
// which as plain torch ops would take some 10^5 launches a frame.
//
// H1 (haar_cascade_kernel): one thread a window.  The cascade's flat
// tables are read through the read-only path; every thread of a warp reads
// the same node, so each load is a broadcast.  A window stops at its first
// failed stage, which is what makes a cascade cheap: `passed` equals the
// plain version everywhere and `score` equals it where `passed` (a failed
// window keeps the failing stage's sum).  What bounds it is the (window,
// node) evaluations the early exit leaves, each at most 12 corner loads
// and about 20 operations; the loads of neighbouring windows fall in the
// same cache lines.  Every rounding is the plain version's: plain float32
// features with one FMA a rect (ops/numerics.fma32's float64 product and
// sum), tilted features in float64 with the plain version's split
// product, the window variance fused or not as the cascade's form says.
//
// H2 (tilted_integral_kernel): the recurrence t[y+1, x] = t[y, x-1] +
// t[y, x+1] - t[y-1, x] + I[y, x-1] + I[y-1, x-1] in float64, summed left
// to right.  One block a plane walks the rows, threads across the
// W + H + 129 columns and one barrier a row: bit exact.  It is bound by
// the chain of rows (a load, four adds and a barrier a row).
#include <cuda_runtime.h>

namespace {

constexpr int kStride = 2;
constexpr int kTiltPad = 64;
constexpr int kMaxRects = 3;

// ops/numerics.fma32: the exact float64 product of two float32 values plus
// a float32 sum, rounded in float64 and then to float32.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// ops/haar._fma64: w * s + c in float64 with the product split in two
// exact halves and the sum's error carried.
__device__ __forceinline__ double fma64(double w, double s, double c) {
  const double hi = static_cast<double>(__double2float_rn(s));
  const double lo = __dsub_rn(s, hi);
  const double p_hi = __dmul_rn(w, hi);
  const double p_lo = __dmul_rn(w, lo);
  const double sum = __dadd_rn(p_hi, c);
  const double bv = __dsub_rn(sum, p_hi);
  const double err = __dadd_rn(__dsub_rn(p_hi, __dsub_rn(sum, bv)),
                               __dsub_rn(c, bv));
  return __dadd_rn(sum, __dadd_rn(err, p_lo));
}

struct Tables {
  const int* rects;        // [N, 3, 4] (ry, rx, rh, rw)
  const float* weights;    // [N, 3]
  const int* tilted;       // [N]
  const float* thr;        // [N]
  const float* leaf;       // [N, 2]
  const int* child;        // [N, 2]
  const int* tree_nodes;   // [T + 1]
  const int* stage_trees;  // [S + 1]
  const float* stage_thr;  // [S]
};

__global__ void haar_cascade_kernel(const float* ii, const float* sq,
                                    const double* tii, Tables tb,
                                    unsigned char* passed, float* score,
                                    int b, int hi, int wi, int wt, int ny,
                                    int nx, int ww, int wh, int n_stages,
                                    int fused_variance) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per = static_cast<long long>(ny) * nx;
  if (gid >= per * b) return;
  const int f = static_cast<int>(gid / per);
  const int p = static_cast<int>(gid % per);
  const int y0 = (p / nx) * kStride;
  const int x0 = (p % nx) * kStride;
  const float* I = ii + static_cast<size_t>(f) * hi * wi;
  const float* Q = sq + static_cast<size_t>(f) * hi * wi;
  const double* T = wt > 0 ? tii + static_cast<size_t>(f) * hi * wt
                           : nullptr;
  auto at = [&](const float* t, int y, int x) {
    return __ldg(t + static_cast<size_t>(y0 + y) * wi + x0 + x);
  };
  auto tat = [&](int y, int x) -> double {
    const int yy = y0 + y;
    if (yy >= hi) return 0.0;        // the plain version's zero pad rows
    return __ldg(T + static_cast<size_t>(yy) * wt + x0 + x + kTiltPad);
  };
  auto rsum = [&](const float* t) {
    return __fadd_rn(__fsub_rn(__fsub_rn(at(t, wh, ww), at(t, 0, ww)),
                               at(t, wh, 0)),
                     at(t, 0, 0));
  };

  const float area = static_cast<float>(ww * wh);
  const float inv_area = __fdiv_rn(1.0f, area);
  const double inv_area64 = __ddiv_rn(1.0, static_cast<double>(ww * wh));
  const float mean = __fmul_rn(rsum(I), inv_area);
  const float mm = __fmul_rn(mean, mean);
  float variance =
      fused_variance ? fma32(rsum(Q), inv_area, -mm)
                     : __fsub_rn(__fmul_rn(rsum(Q), inv_area), mm);
  variance = fmaxf(variance, 0.0f);
  const float vnorm =
      variance > 0.0f
          ? __double2float_rn(__dsqrt_rn(static_cast<double>(variance)))
          : 1.0f;

  bool ok = true;
  float st_sum = 0.0f;
  for (int s = 0; s < n_stages && ok; ++s) {
    st_sum = 0.0f;
    const int t1 = __ldg(tb.stage_trees + s + 1);
    for (int t = __ldg(tb.stage_trees + s); t < t1; ++t) {
      int cur = __ldg(tb.tree_nodes + t);
      float val = 0.0f;
      while (true) {
        const int* r = tb.rects + cur * kMaxRects * 4;
        const float* w = tb.weights + cur * kMaxRects;
        const float limit = __fmul_rn(__ldg(tb.thr + cur), vnorm);
        bool left;
        if (__ldg(tb.tilted + cur)) {
          double acc = 0.0;
          for (int k = 0; k < kMaxRects; ++k) {
            const float wk = __ldg(w + k);
            if (wk == 0.0f) continue;
            const int ry = __ldg(r + 4 * k), rx = __ldg(r + 4 * k + 1);
            const int rh = __ldg(r + 4 * k + 2), rw = __ldg(r + 4 * k + 3);
            const double v = __dadd_rn(
                __dsub_rn(__dsub_rn(tat(ry, rx), tat(ry + rh, rx - rh)),
                          tat(ry + rw, rx + rw)),
                tat(ry + rw + rh, rx + rw - rh));
            acc = fma64(static_cast<double>(wk), v, acc);
          }
          left = __dmul_rn(acc, inv_area64) < static_cast<double>(limit);
        } else {
          float acc = 0.0f;
          for (int k = 0; k < kMaxRects; ++k) {
            const float wk = __ldg(w + k);
            if (wk == 0.0f) continue;
            const int ry = __ldg(r + 4 * k), rx = __ldg(r + 4 * k + 1);
            const int rh = __ldg(r + 4 * k + 2), rw = __ldg(r + 4 * k + 3);
            const float v = __fadd_rn(
                __fsub_rn(__fsub_rn(at(I, ry + rh, rx + rw),
                                    at(I, ry, rx + rw)),
                          at(I, ry + rh, rx)),
                at(I, ry, rx));
            acc = fma32(wk, v, acc);
          }
          left = __fmul_rn(acc, inv_area) < limit;
        }
        const int side = left ? 0 : 1;
        const int nxt = __ldg(tb.child + 2 * cur + side);
        if (nxt < 0) {
          val = __ldg(tb.leaf + 2 * cur + side);
          break;
        }
        cur = nxt;
      }
      st_sum = __fadd_rn(st_sum, val);
    }
    ok = st_sum >= __ldg(tb.stage_thr + s);
  }
  passed[gid] = ok ? 1 : 0;
  score[gid] = st_sum;
}

// One block a plane; each thread owns the columns x = tid, tid + blockDim,
// ...  Row y + 1 reads row y and y - 1 of the output, written before the
// barrier that ends the previous row.
__global__ void tilted_integral_kernel(const double* xf, double* out, int h,
                                       int wp) {
  const int f = blockIdx.x;
  const int w1 = wp + 1;
  const double* X = xf + static_cast<size_t>(f) * h * wp;
  double* O = out + static_cast<size_t>(f) * (h + 1) * w1;
  for (int x = threadIdx.x; x < w1; x += blockDim.x) O[x] = 0.0;
  __syncthreads();
  for (int y = 0; y < h; ++y) {
    const double* prev = O + static_cast<size_t>(y) * w1;
    double* row = O + static_cast<size_t>(y + 1) * w1;
    for (int x = threadIdx.x; x < w1; x += blockDim.x) {
      const double left = x > 0 ? prev[x - 1] : 0.0;
      const double right = x < wp ? prev[x + 1] : 0.0;
      const double prev2 = y > 0 ? O[static_cast<size_t>(y - 1) * w1 + x]
                                 : 0.0;
      const double i1 = x > 0 ? X[static_cast<size_t>(y) * wp + x - 1] : 0.0;
      const double i2 = (x > 0 && y > 0)
                            ? X[static_cast<size_t>(y - 1) * wp + x - 1]
                            : 0.0;
      row[x] = __dadd_rn(
          __dadd_rn(__dsub_rn(__dadd_rn(left, right), prev2), i1), i2);
    }
    __syncthreads();
  }
}

// The latency of one row of the wavefront: one block of 1024 threads runs
// `steps` rows of a [2, 1024] float64 ring in shared memory (two
// neighbour loads, the four sums, a store and the barrier) and reports
// the clock cycles they took.  Used for tilted_integral's chain bound.
__global__ void tilted_cycles_kernel(long long* out, int steps) {
  __shared__ double ring[2][1026];
  const int x = threadIdx.x + 1;
  ring[0][x] = x;
  ring[1][x] = 0.5 * x;
  if (threadIdx.x < 2) ring[0][threadIdx.x * 1025] = ring[1][threadIdx.x * 1025] = 0.0;
  __syncthreads();
  const long long t0 = clock64();
  for (int y = 0; y < steps; ++y) {
    const double* prev = ring[y & 1];
    double* row = ring[(y + 1) & 1];
    const double v = __dadd_rn(
        __dadd_rn(__dsub_rn(__dadd_rn(prev[x - 1], prev[x + 1]), row[x]),
                  static_cast<double>(y)),
        0.25);
    __syncthreads();
    row[x] = v;
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = static_cast<long long>(ring[steps & 1][1]);
  }
}

}  // namespace

extern "C" int gst_haar_tilted_step_cycles(void* out, int steps,
                                           void* stream) {
  tilted_cycles_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_haar_cascade(
    const void* ii, const void* sq, const void* tii, const void* rects,
    const void* weights, const void* tilted, const void* thr,
    const void* leaf, const void* child, const void* tree_nodes,
    const void* stage_trees, const void* stage_thr, void* passed,
    void* score, int b, int hi, int wi, int wt, int ny, int nx, int ww,
    int wh, int n_stages, int fused_variance, void* stream) {
  const long long n = static_cast<long long>(b) * ny * nx;
  if (n <= 0) return 0;
  Tables tb{static_cast<const int*>(rects),
            static_cast<const float*>(weights),
            static_cast<const int*>(tilted), static_cast<const float*>(thr),
            static_cast<const float*>(leaf), static_cast<const int*>(child),
            static_cast<const int*>(tree_nodes),
            static_cast<const int*>(stage_trees),
            static_cast<const float*>(stage_thr)};
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  haar_cascade_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ii), static_cast<const float*>(sq),
      static_cast<const double*>(tii), tb,
      static_cast<unsigned char*>(passed), static_cast<float*>(score), b, hi,
      wi, wt, ny, nx, ww, wh, n_stages, fused_variance);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_haar_tilted_integral(const void* xf, void* out, int b,
                                        int h, int wp, void* stream) {
  if (b <= 0) return 0;
  tilted_integral_kernel<<<b, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xf), static_cast<double*>(out), h, wp);
  return static_cast<int>(cudaGetLastError());
}
