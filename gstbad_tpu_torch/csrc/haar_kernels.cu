// Haar cascade evaluation (gstbad_tpu_torch/ops/haar.py): H1 walks one
// pyramid scale of a window of frames, H2 builds OpenCV's rotated
// summed-area table.  Neither replaces a TPU kernel: they replace the JAX
// package's scan over a face cascade's ~1050 trees
// (gstbad_tpu/ops/haar.py:343-375), its node-by-node unrolled hand
// cascades (:130-190) and its row scan of the rotated table (:72-101),
// which as plain torch ops would take some 10^5 launches a frame.
//
// H1 (haar_cascade_kernel): a block of 256 threads a tile of windows
// (ops/haar.py plan: 32 x 16 stride-2 windows).  A window stops at its
// first failed stage, which is what makes a cascade cheap: on a face
// window's largest scale the mean window evaluates 29.6 of alt2's 2094
// nodes, but a warp of neighbouring windows runs until its last one fails
// (about 6x the mean there).  So the block keeps a list of the windows
// still alive: each stage runs one thread a window of the list, and the
// survivors are compacted into the next list (a warp's ballot and one
// shared atomic a warp).  Once plan.warp_max or fewer are left, each goes
// to a warp of its own whose lanes take the stage's trees 32 at a time;
// every lane then adds the 32 values in tree order, the plain version's
// serial sum (never a tree reduction, whose roundings differ).  The
// tile's region of ii (and of the rotated table) is copied into shared
// memory once, a row's even columns before its odd ones, so that
// neighbouring windows read neighbouring banks; a node is a 64-byte
// record (ops/haar.py Plan) whose corners are 16-bit offsets into those
// regions, the first records kept in shared memory too.  `passed` equals
// the plain version everywhere and `score` equals it where `passed` (a
// failed window keeps the failing stage's sum).  Every rounding is the
// plain version's: plain float32 features with one FMA a rect
// (ops/numerics.fma32's float64 product and sum), tilted features in
// float64 with the plain version's split product, the window variance
// fused or not as the cascade's form says.  Its bound counts the (window,
// node) evaluations the early exit leaves at a few FP32 operations each;
// an evaluation here issues its record's loads, up to 12 corner loads and
// the float64 products and conversions of fma32, and the blocks whose
// faces keep windows alive to the last stages run their tails on a few
// warps (PERF.md section 6).
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// A tile's geometry (ops/haar.py Plan): the tile of windows, the region
// of each table it copies (first row and column from the tile's first
// window, rows, pitch; even columns first in a row), the node records
// kept in shared memory and the survivors at which warps take over.
struct Geo {
  int tx, ty;
  int dy0, dx0, rows, pitch;
  int tdy0, tdx0, trows, tpitch;
  int n_smem, warp_max;
};

// What a window's evaluation reads: its regions (offset to the window),
// its variance norm and the node records.
struct Win {
  const float* ri;
  const double* rt;
  float vnorm;
};

struct Ctx {
  const int4* s_nodes;
  const int4* g_nodes;
  int n_smem;
  float inv_area;
  double inv_area64;
};

__device__ __forceinline__ float f32(int v) { return __int_as_float(v); }

__device__ __forceinline__ int corner(const int4& q, int k, int j) {
  // corner j of rect k: 16-bit offsets, two an int, ints 0..5
  const int v = (k == 0 ? (j < 2 ? q.x : q.y)
                        : (j < 2 ? q.z : q.w));
  return (j & 1) ? (static_cast<unsigned>(v) >> 16) : (v & 0xffff);
}

// One tree at one window: from its root to a leaf.  Every rounding is
// the plain version's.
__device__ float eval_tree(int n, const Win& w, const Ctx& c) {
  while (true) {
    int4 q0, q1, q2, q3;
    if (n < c.n_smem) {
      const int4* r = c.s_nodes + 4 * n;
      q0 = r[0]; q1 = r[1]; q2 = r[2]; q3 = r[3];
    } else {
      const int4* r = c.g_nodes + 4 * n;
      q0 = __ldg(r); q1 = __ldg(r + 1); q2 = __ldg(r + 2); q3 = __ldg(r + 3);
    }
    const int nrect = q3.z & 0xff;
    const float wk[kMaxRects] = {f32(q1.z), f32(q1.w), f32(q2.x)};
    const float limit = __fmul_rn(f32(q2.y), w.vnorm);
    bool left;
    if (q3.z & 0x100) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < kMaxRects; ++k) {
        if (k >= nrect) break;
        const int4& q = k < 2 ? q0 : q1;
        const int kk = k < 2 ? k : 0;
        const double v = __dadd_rn(
            __dsub_rn(__dsub_rn(w.rt[corner(q, kk, 0)], w.rt[corner(q, kk, 1)]),
                      w.rt[corner(q, kk, 2)]),
            w.rt[corner(q, kk, 3)]);
        acc = fma64(static_cast<double>(wk[k]), v, acc);
      }
      left = __dmul_rn(acc, c.inv_area64) < static_cast<double>(limit);
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxRects; ++k) {
        if (k >= nrect) break;
        const int4& q = k < 2 ? q0 : q1;
        const int kk = k < 2 ? k : 0;
        const float v = __fadd_rn(
            __fsub_rn(__fsub_rn(w.ri[corner(q, kk, 0)], w.ri[corner(q, kk, 1)]),
                      w.ri[corner(q, kk, 2)]),
            w.ri[corner(q, kk, 3)]);
        acc = fma32(wk[k], v, acc);
      }
      left = __fmul_rn(acc, c.inv_area) < limit;
    }
    const int nxt = left ? q3.x : q3.y;
    if (nxt < 0) return f32(left ? q2.z : q2.w);
    n = nxt;
  }
}

// A region's offset of the table entry (dy, dx) from the tile's first
// window (ops/haar.region_offset).
__device__ __forceinline__ int rel(int dy, int dx, int dy0, int dx0,
                                   int pitch) {
  const int c = dx - dx0;
  return (dy - dy0) * pitch + (c & 1) * (pitch >> 1) + (c >> 1);
}

// H1: a block a tile of geo.tx x geo.ty windows of one frame.  The tile's
// regions of ii (and of the rotated table) and the first node records go
// into shared memory once.  Each stage then runs over the block's list
// of windows still alive, one thread a window, and the survivors are
// compacted into the next list (a warp's ballot, one shared atomic a
// warp); a window that fails, or passes the last stage, writes its
// outputs.  Once geo.warp_max or fewer windows are alive, each goes to a
// warp: the lanes take the stage's trees 32 at a time and every lane adds
// the 32 values in tree order, the plain version's serial sum.
__global__ void __launch_bounds__(kThreads)
haar_cascade_kernel(const float* ii, const float* sq, const double* tii,
                    const int4* nodes, const int* tree_nodes,
                    const int* stage_trees, const float* stage_thr,
                    unsigned char* passed, float* score, int hi, int wi,
                    int wt, int ny, int nx, int ww, int wh, int n_stages,
                    int fused_variance, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count[3];
  const int tile_n = g.tx * g.ty;
  int4* s_nodes = reinterpret_cast<int4*>(smem);
  double* s_t = reinterpret_cast<double*>(s_nodes + 4 * g.n_smem);
  float* s_i = reinterpret_cast<float*>(s_t + g.trows * g.tpitch);
  float* s_vn = s_i + g.rows * g.pitch;
  unsigned short* s_list = reinterpret_cast<unsigned short*>(s_vn + tile_n);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = blockIdx.z;
  const int wy0 = blockIdx.y * g.ty, wx0 = blockIdx.x * g.tx;
  const int y0 = wy0 * kStride, x0 = wx0 * kStride;
  const float* I = ii + static_cast<size_t>(f) * hi * wi;
  const float* Q = sq + static_cast<size_t>(f) * hi * wi;

  for (int i = tid; i < 4 * g.n_smem; i += kThreads) s_nodes[i] = nodes[i];
  const int half = g.pitch >> 1;
  for (int i = tid; i < g.rows * g.pitch; i += kThreads) {
    const int r = i / g.pitch, c = i - r * g.pitch;
    const int gy = y0 + g.dy0 + r, gx = x0 + g.dx0 + c;
    s_i[r * g.pitch + (c & 1) * half + (c >> 1)] =
        (gy >= 0 && gy < hi && gx >= 0 && gx < wi) ? I[gy * wi + gx] : 0.0f;
  }
  if (g.trows > 0) {
    const double* T = tii + static_cast<size_t>(f) * hi * wt;
    const int thalf = g.tpitch >> 1;
    for (int i = tid; i < g.trows * g.tpitch; i += kThreads) {
      const int r = i / g.tpitch, c = i - r * g.tpitch;
      const int gy = y0 + g.tdy0 + r, gx = x0 + kTiltPad + g.tdx0 + c;
      // rows past the table are the plain version's zero pad rows
      s_t[r * g.tpitch + (c & 1) * thalf + (c >> 1)] =
          (gy >= 0 && gy < hi && gx >= 0 && gx < wt) ? T[gy * wt + gx] : 0.0;
    }
  }
  if (tid < 3) s_count[tid] = 0;
  __syncthreads();

  Ctx c{s_nodes, nodes, g.n_smem, __fdiv_rn(1.0f, static_cast<float>(ww * wh)),
        __ddiv_rn(1.0, static_cast<double>(ww * wh))};
  auto out_index = [&](int w) {
    const int wy = w / g.tx;
    return (static_cast<size_t>(f) * ny + wy0 + wy) * nx + wx0 + (w - wy * g.tx);
  };
  auto window = [&](int w) {
    const int wy = w / g.tx, wx = w - wy * g.tx;
    return Win{s_i + wy * kStride * g.pitch + wx,
               s_t + wy * kStride * g.tpitch + wx, s_vn[w]};
  };
  // append the windows whose flag is set to list b (a warp's ballot)
  auto append = [&](bool keep, int w, int b) {
    const unsigned m = __ballot_sync(kAll, keep);
    if (m == 0) return;
    int base = 0;
    if (lane == 0) base = atomicAdd(&s_count[b % 3], __popc(m));
    base = __shfl_sync(kAll, base, 0);
    if (keep)
      s_list[(b & 1) * tile_n + base + __popc(m & ((1u << lane) - 1))] = w;
  };

  // the windows of the grid, their variance norms, into list 0
  const int o00 = rel(0, 0, g.dy0, g.dx0, g.pitch);
  const int o0w = rel(0, ww, g.dy0, g.dx0, g.pitch);
  const int oh0 = rel(wh, 0, g.dy0, g.dx0, g.pitch);
  const int ohw = rel(wh, ww, g.dy0, g.dx0, g.pitch);
  for (int w = tid; w < tile_n; w += kThreads) {
    const int wy = w / g.tx, wx = w - wy * g.tx;
    const bool valid = wy0 + wy < ny && wx0 + wx < nx;
    if (valid) {
      const float* R = s_i + wy * kStride * g.pitch + wx;
      const float* q = Q + (y0 + wy * kStride) * wi + x0 + wx * kStride;
      const float tot = __fadd_rn(
          __fsub_rn(__fsub_rn(R[ohw], R[o0w]), R[oh0]), R[o00]);
      const float tsq = __fadd_rn(
          __fsub_rn(__fsub_rn(__ldg(q + wh * wi + ww), __ldg(q + ww)),
                    __ldg(q + wh * wi)),
          __ldg(q));
      const float mean = __fmul_rn(tot, c.inv_area);
      const float mm = __fmul_rn(mean, mean);
      float variance = fused_variance
                           ? fma32(tsq, c.inv_area, -mm)
                           : __fsub_rn(__fmul_rn(tsq, c.inv_area), mm);
      variance = fmaxf(variance, 0.0f);
      s_vn[w] = variance > 0.0f ? __double2float_rn(
                                      __dsqrt_rn(static_cast<double>(variance)))
                                : 1.0f;
      if (n_stages == 0) {
        passed[out_index(w)] = 1;
        score[out_index(w)] = 0.0f;
      }
    }
    append(valid && n_stages > 0, w, 0);
  }
  __syncthreads();

  // the stages, one thread a window of the list
  int s = 0;
  int n = s_count[0];
  for (; s < n_stages && n > g.warp_max; ++s) {
    const int t0 = __ldg(stage_trees + s), t1 = __ldg(stage_trees + s + 1);
    const float thr = __ldg(stage_thr + s);
    const bool last = s == n_stages - 1;
    const unsigned short* in = s_list + (s & 1) * tile_n;
    if (tid == 0) s_count[(s + 2) % 3] = 0;   // read in the stage before
    for (int e = tid; e < ((n + 31) & ~31); e += kThreads) {
      bool keep = false;
      int w = 0;
      if (e < n) {
        w = in[e];
        const Win win = window(w);
        float st = 0.0f;
        for (int t = t0; t < t1; ++t)
          st = __fadd_rn(st, eval_tree(__ldg(tree_nodes + t), win, c));
        const bool ok = st >= thr;
        if (!ok || last) {
          passed[out_index(w)] = ok ? 1 : 0;
          score[out_index(w)] = st;
        }
        keep = ok && !last;
      }
      append(keep, w, s + 1);
    }
    __syncthreads();
    n = s_count[(s + 1) % 3];
  }

  // the rest, a warp a window
  const unsigned short* in = s_list + (s & 1) * tile_n;
  for (int e = warp; s < n_stages && e < n; e += kWarps) {
    const int w = in[e];
    const Win win = window(w);
    for (int ss = s; ss < n_stages; ++ss) {
      const int t0 = __ldg(stage_trees + ss), t1 = __ldg(stage_trees + ss + 1);
      float st = 0.0f;
      for (int t = t0; t < t1; t += 32) {
        const float v = t + lane < t1
                            ? eval_tree(__ldg(tree_nodes + t + lane), win, c)
                            : 0.0f;
        const int cnt = min(32, t1 - t);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float u = __shfl_sync(kAll, v, j);
          if (j < cnt) st = __fadd_rn(st, u);
        }
      }
      const bool ok = st >= __ldg(stage_thr + ss);
      if (!ok || ss == n_stages - 1) {
        if (lane == 0) {
          passed[out_index(w)] = ok ? 1 : 0;
          score[out_index(w)] = st;
        }
        break;
      }
    }
  }
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
    const void* ii, const void* sq, const void* tii, const void* nodes,
    const void* tree_nodes, const void* stage_trees, const void* stage_thr,
    void* passed, void* score, int b, int hi, int wi, int wt, int ny,
    int nx, int ww, int wh, int n_stages, int fused_variance, int tx,
    int ty, int dy0, int dx0, int rows, int pitch, int tdy0, int tdx0,
    int trows, int tpitch, int n_smem, int warp_max, void* stream) {
  if (static_cast<long long>(b) * ny * nx <= 0) return 0;
  if (tx * ty % 32 != 0 || tx * ty > 65535 || (pitch & 1) || (tpitch & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{tx, ty, dy0, dx0, rows, pitch, tdy0, tdx0, trows, tpitch,
              n_smem, warp_max};
  const size_t smem = static_cast<size_t>(n_smem) * 64 +
                      8ull * trows * tpitch + 4ull * rows * pitch +
                      4ull * tx * ty + 4ull * tx * ty;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        haar_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((nx + tx - 1) / tx, (ny + ty - 1) / ty, b);
  haar_cascade_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ii), static_cast<const float*>(sq),
      static_cast<const double*>(tii), static_cast<const int4*>(nodes),
      static_cast<const int*>(tree_nodes),
      static_cast<const int*>(stage_trees),
      static_cast<const float*>(stage_thr),
      static_cast<unsigned char*>(passed), static_cast<float*>(score), hi,
      wi, wt, ny, nx, ww, wh, n_stages, fused_variance, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_haar_tilted_integral(const void* xf, void* out, int b,
                                        int h, int wp, void* stream) {
  if (b <= 0) return 0;
  tilted_integral_kernel<<<b, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xf), static_cast<double*>(out), h, wp);
  return static_cast<int>(cudaGetLastError());
}
