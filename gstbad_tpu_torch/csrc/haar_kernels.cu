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
// to right, over the W + H + 129 columns of a plane's table: bit exact.
// One block a plane walks the rows, C columns a thread, rows k and k - 1
// in registers and row k's copy in shared memory for the neighbours' edge
// columns, one barrier a row.  Its last thread moves the data RB rows
// (4, 2 or 1: the most whose rings fit, tilt_rows) at a time: the float32
// planes' rows as they are (the margins are implicit zeros) by one bulk
// copy (TMA) of the 16-byte units around them into a ring three blocks
// ahead, and finished rows out by one bulk copy from a shared region laid
// out as in memory, so that a row's waits, fences and copies come once a
// block.  Whatever more that thread does once a block lies on the walk's
// chain: copying a block's unaligned ends by cp.async, or clipping its
// copy to the tensor, cost 0.16-0.18 ms a hand window of 2.2 (PERF.md
// section 6), so the wrapper copies a tensor that does not start and end
// on 16-byte boundaries instead (none on the main path).  Columns past the
// table's nonzero span (it spreads one column a row from the image) are
// exactly zero and skipped a warp at a time.  Every warp runs one form of
// the row step: forms for warps inside the image, outside it and across
// its edges ran slower together than any one alone (the instruction
// cache).  Its chain is the rows in order times the smaller of two row
// steps: this walk's own with its global loads and stores compiled out
// (kProbe) and the earlier design's (tilted_ring_cycles_kernel).  The
// earlier design, a
// block of 1024 threads a plane that read rows k and k - 1 back from its
// global output and from a float64 padded copy of the plane after each
// barrier, spent about 3300 cycles a row; this one about 610, of which its
// walk without the copies takes about 465 and the ring step 313 (PERF.md
// section 6).
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

// ---------------------------------------------------------------------------
// H2: the rotated table, one block a plane
// ---------------------------------------------------------------------------

constexpr int kTiltMaxThreads = 512;   // ops/haar.tilted_plan's limit
constexpr int kTiltInSlots = 3;   // input blocks in the ring

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// what this thread wrote to shared memory, made visible to the bulk copy
// engine (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from shared to global memory, as a group of its own
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// wait until none of this thread's bulk stores still reads shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a bulk (TMA) copy of `bytes` from global to shared memory whose arrival
// completes the mbarrier's phase (the mbarrier expects them first)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, unsigned long long* mb) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(smem_u32(mb)),
      "r"(bytes), "r"(smem_u32(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* mb) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(mb))
               : "memory");
}

// wait for the mbarrier's phase of this parity to complete
__device__ __forceinline__ void mbar_wait(unsigned long long* mb,
                                          int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(mb)), "r"(parity)
        : "memory");
  } while (!done);
}

// A block of RB rows of the table in shared memory as in global memory:
// rows one after another, w1 doubles apart, the first at the element
// offset its row has from a 16-byte boundary; two such regions.  Input
// rows likewise, RB of them a slot, kTiltInSlots slots.
__host__ __device__ inline long long tilt_out_region(int w1, int rb) {
  return (static_cast<long long>(rb) * w1 + 2) & ~1ll;   // doubles
}
__host__ __device__ inline long long tilt_in_slot(int w, int rb) {
  return (static_cast<long long>(rb) * w + 6) & ~3ll;    // floats
}
__host__ __device__ inline long long tilt_smem(int w1, int w, int rb) {
  return 8 * (2 * tilt_out_region(w1, rb) + ((w1 + 2) & ~1)) +
         4 * kTiltInSlots * tilt_in_slot(w, rb);
}

// One row step of a thread's C columns x0 .. x0 + C - 1: the new row
// from row k (cur, with the neighbours' edge columns read from src, the
// shared copy of row k), row k - 1 (nxt, overwritten in place by the new
// row) and the input rows k (irow, its shared copy) and k - 1 (ip,
// float64, overwritten by row k's).  The new row also goes to dst.  Every
// sum in the plain version's order; columns at or past w1 stay 0.  One
// form for every warp: forms for the warps inside the image, outside it
// and across its edges ran slower together than any one alone (the
// instruction cache).
template <int C>
__device__ __forceinline__ void tilt_row(const double (&cur)[C],
                                         double (&nxt)[C], double (&ip)[C],
                                         const double* src, double* dst,
                                         const float* irow, int x0, int w1,
                                         int w) {
  // the neighbours' edge columns (none for a thread past the table)
  const double lft = x0 > 0 && x0 <= w1 ? src[x0 - 1] : 0.0;
  const double rgt = x0 + C < w1 ? src[x0 + C] : 0.0;
  const float* in = irow + x0 - (kTiltPad + 1);   // I[y, x-1] at column x
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const double left = j > 0 ? cur[j - 1] : lft;
    const double right = j < C - 1 ? cur[j + 1] : rgt;
    const double i1 = static_cast<unsigned>(x0 + j - (kTiltPad + 1)) <
                              static_cast<unsigned>(w)
                          ? static_cast<double>(in[j])
                          : 0.0;
    const double v = __dadd_rn(
        __dadd_rn(__dsub_rn(__dadd_rn(left, right), nxt[j]), i1), ip[j]);
    nxt[j] = x0 + j < w1 ? v : 0.0;
    ip[j] = i1;
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (x0 + j < w1) dst[x0 + j] = nxt[j];
}

// The columns of row r (r >= 1) that can be nonzero: the input fills
// columns TILT_PAD + 1 .. TILT_PAD + w of row 1, and each row spreads one
// column further either way; the rest are exactly +0.0 in every row
// before r too.  A warp with none of its columns inside does nothing: its
// registers and every shared copy of its columns hold zeros already.
template <int C>
__device__ __forceinline__ void tilt_step(const double (&cur)[C],
                                          double (&nxt)[C], double (&ip)[C],
                                          const double* src, double* dst,
                                          const float* irow, int x0, int w1,
                                          int w, int r) {
  // the warp's columns are x0 - lane * C .. x0 + (31 - lane) * C + C - 1
  const int lo = max(0, kTiltPad + 2 - r), hi = kTiltPad + w - 1 + r;
  const int lane = threadIdx.x & 31;
  if (x0 - lane * C > hi || x0 + (32 - lane) * C <= lo) return;
  tilt_row<C>(cur, nxt, ip, src, dst, irow, x0, w1, w);
}

struct TiltGeo {
  int h, w, w1;
  int reps;   // passes over the rows: 1, or the probe's count
};

// H2: a block a plane, thread t the C columns t*C ..: rows k and k - 1 in
// registers (two arrays that swap roles each row), row k's copy in shared
// memory for the neighbours' edge columns, one barrier a row.  The
// block's last thread (the mover) moves the data, RB rows at a time: a
// block of input rows (one piece of memory) comes into a ring of
// kTiltInSlots blocks by one bulk copy (TMA, an mbarrier a slot) of the
// 16-byte units around it; a finished block of table rows goes out by one
// bulk copy from its shared region, which is laid out as the rows are in
// memory, and the one or two elements off its 16-byte span by thread 0.
//
// kProbe: the same walk over one plane's rows g.reps times with every
// global load and store left out (the input ring holds fixed values), and
// its clock cycles in out[0] (int64), the rows a block in out[2]: the
// kernel's own row steps, barriers and block ends, for its chain.
template <int C, int RB, bool kProbe>
__global__ void __launch_bounds__(kTiltMaxThreads)
tilted_integral_kernel(const float* x, double* out, TiltGeo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long mbar[kTiltInSlots];
  const int h = g.h, w = g.w, w1 = g.w1;
  const long long oreg = tilt_out_region(w1, RB), islot = tilt_in_slot(w, RB);
  double* obuf = reinterpret_cast<double*>(smem);   // two regions
  double* zrow = obuf + 2 * oreg;                   // row 0: zeros
  float* ibuf = reinterpret_cast<float*>(zrow + ((w1 + 2) & ~1));
  const int tid = threadIdx.x, nt = blockDim.x, x0 = tid * C;
  const int mover = nt - 1;
  const float* X = x + static_cast<size_t>(blockIdx.x) * h * w;
  const size_t o0 = static_cast<size_t>(blockIdx.x) * (h + 1) * w1;
  double* O = out + o0;
  const bool loads = !kProbe && h > 0 && w > 0;
  const int nblk = (h + RB - 1) / RB;   // input blocks, and output blocks

  // input block b (rows b*RB ..) into slot b % kTiltInSlots, row i's
  // element j at i*w + j + ioff(b), its offset from a 16-byte boundary
  auto ioff = [&](int b) {
    if (kProbe) return 0;
    return static_cast<int>(
        (reinterpret_cast<size_t>(X + static_cast<size_t>(b) * RB * w) >> 2) &
        3);
  };
  // the mover stages it by one bulk copy of the 16-byte units around its
  // floats (x starts on a 16-byte boundary and may be read to the one
  // after its last float: gst_haar_tilted_integral checks)
  auto stage = [&](int b) {
    if (loads && tid == mover && b < nblk) {
      const int n = min(RB, h - b * RB) * w;
      bulk_load(ibuf + (b % kTiltInSlots) * islot,
                X + static_cast<size_t>(b) * RB * w - ioff(b),
                4 * ((ioff(b) + n + 3) & ~3), mbar + b % kTiltInSlots);
    }
  };
  // the mover waits for input block b's bulk copy; the barrier after
  // shows it to all
  auto arrived = [&](int b) {
    if (loads && b < nblk && tid == mover)
      mbar_wait(mbar + b % kTiltInSlots, (b / kTiltInSlots) & 1);
  };

  for (int i = tid; i < 2 * oreg + ((w1 + 2) & ~1); i += nt) obuf[i] = 0.0;
  if (kProbe)
    for (int i = tid; i < kTiltInSlots * islot; i += nt)
      ibuf[i] = 0.25f * (i % 31);
  else
    for (int i = tid; i < w1; i += nt) O[i] = 0.0;
  if (tid == mover) {
    for (int q = 0; q < kTiltInSlots; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(mbar + q))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int b = 0; b < kTiltInSlots; ++b) stage(b);
  arrived(0);
  __syncthreads();

  double ra[C], rb[C], ip[C];
  const long long t0 = kProbe ? clock64() : 0;
  for (int rep = 0; rep < g.reps; ++rep) {
#pragma unroll
    for (int j = 0; j < C; ++j) ra[j] = rb[j] = ip[j] = 0.0;
    // where the walk is: output block b (rows 1 + b*RB ..) in the region
    // starting at its first element's parity (so that 16-byte aligned
    // memory is aligned in shared memory too), row k's shared copy, input
    // row k
    int b = 0;
    int par = static_cast<int>((o0 + w1) & 1);
    double* region = obuf + par;
    const double* srow = zrow;
    int ioffb = ioff(0);
    const float* irow = ibuf + ioffb;
    // row k + 1 into `nxt` from `cur`, the i-th of its block
    auto row_step = [&](int k, int i, const double (&cur)[C],
                        double (&nxt)[C]) {
      double* drow = region + i * w1;
      tilt_step<C>(cur, nxt, ip, srow, drow, irow, x0, w1, w, k + 1);
      srow = drow;
      irow += w;
      if (i < RB - 1 && k + 1 < h) {
        __syncthreads();
        return;
      }
      // the block's end: rows first .. k + 1 out, [par, end) of its n
      // elements by one bulk copy, the one or two others by thread 0 (the
      // last element is past the nonzero span: 0)
      const int first = 1 + b * RB, n = (k + 2 - first) * w1;
      const int end = par + ((n - par) & ~1);
      fence_async_shared();
      if (tid == mover) bulk_wait_read();   // the other region is free
      arrived(b + 1);
      __syncthreads();
      if (!kProbe) {
        double* g0 = O + static_cast<size_t>(first) * w1;
        if (tid == mover)
          bulk_store(g0 + par, region + par, 8 * (end - par));
        if (tid == 0 && par) g0[0] = region[0];
        if (tid == 0 && end < n) g0[n - 1] = 0.0;
      }
      // input block b was last read before the barrier
      stage(b + kTiltInSlots);
      ++b;
      par ^= (RB * w1) & 1;
      region = obuf + (b & 1) * oreg + par;
      ioffb = (ioffb + RB * w) & 3;
      irow = ibuf + (b % kTiltInSlots) * islot + ioffb;
    };
    for (int k = 0; k < h; k += 2) {   // a block's rows: k % RB
      row_step(k, RB == 4 ? k & 3 : 0, ra, rb);
      if (k + 1 < h) row_step(k + 1, RB == 4 ? (k + 1) & 3 : RB - 1, rb, ra);
    }
  }
  if (tid == mover) bulk_wait_all();
  if (kProbe && tid == 0) {
    long long* o = reinterpret_cast<long long*>(out);
    o[0] = clock64() - t0;
    o[1] = static_cast<long long>(ra[0] + rb[0]);
    o[2] = RB;
  }
}

// The row step of H2's earlier design (kept as the reading the new one is
// held against): one block of 1024 threads runs `steps` rows of a
// [2, 1024] float64 ring in shared memory (two neighbour loads and the
// row before from the ring, the four sums, a store, two barriers).
__global__ void tilted_ring_cycles_kernel(long long* out, int steps) {
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

// the columns a thread may take (odd: a warp's shared stores of a row,
// C doubles apart, fall on distinct banks)
#define TILT_COLS(X) X(1) X(3) X(5) X(7) X(9) X(11) X(13) X(15)

template <typename K>
int tilt_smem_attr(K kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool tilt_geometry_ok(int h, int w, int cols, int threads) {
  const long long w1 = static_cast<long long>(w) + h + 2 * kTiltPad + 1;
  return h >= 0 && w >= 0 && w1 < (1 << 30) && threads >= 32 &&
         threads <= kTiltMaxThreads && threads % 32 == 0 &&
         static_cast<long long>(cols) * threads >= w1;
}

// The most rows a bulk copy (4, 2 or 1) whose rings fit in a block's
// shared memory on this card, or 0 where none does.
int tilt_rows(int h, int w) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, tilted_integral_kernel<1, 1, false>) !=
          cudaSuccess)
    return 0;
  const int w1 = w + h + 2 * kTiltPad + 1;
  for (int rb = 4; rb >= 1; rb /= 2)
    if (tilt_smem(w1, w, rb) + static_cast<long long>(fa.sharedSizeBytes) <=
        optin)
      return rb;
  return 0;
}

// H2 (or its probe) on a grid of `blocks` planes h x w: the table's
// columns over `threads` threads of `cols` columns each
// (ops/haar.tilted_plan), the rows a bulk copy the most whose rings fit
// (tilt_rows): where none fits, nothing runs.
template <bool kProbe>
int tilt_launch(const float* x, double* out, int blocks, int h, int w,
                int cols, int threads, int reps, cudaStream_t st) {
  const int rows = tilt_geometry_ok(h, w, cols, threads) ? tilt_rows(h, w) : 0;
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int w1 = w + h + 2 * kTiltPad + 1;
  const long long smem = tilt_smem(w1, w, rows);
  const TiltGeo g{h, w, w1, reps};
  switch (cols * 8 + rows) {
#define TILT_LAUNCH_RB(C, RB)                                       \
  case C * 8 + RB: {                                                \
    const int e =                                                   \
        tilt_smem_attr(tilted_integral_kernel<C, RB, kProbe>, smem); \
    if (e) return e;                                                \
    tilted_integral_kernel<C, RB, kProbe>                           \
        <<<blocks, threads, smem, st>>>(x, out, g);                 \
    break;                                                          \
  }
#define TILT_LAUNCH(C) \
  TILT_LAUNCH_RB(C, 1) TILT_LAUNCH_RB(C, 2) TILT_LAUNCH_RB(C, 4)
    TILT_COLS(TILT_LAUNCH)
#undef TILT_LAUNCH
#undef TILT_LAUNCH_RB
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// H2's row steps at an h x w plane's geometry (the kernel's walk without
// its loads and stores, one block): out[0] the cycles of `reps` passes
// over the plane's rows, out[2] the rows a block (int64)
extern "C" int gst_haar_tilted_step_cycles(void* out, int reps, int h,
                                           int w, int cols, int threads,
                                           void* stream) {
  if (reps < 1) return static_cast<int>(cudaErrorInvalidValue);
  return tilt_launch<true>(nullptr, static_cast<double*>(out), 1, h, w, cols,
                           threads, reps, static_cast<cudaStream_t>(stream));
}

extern "C" int gst_haar_tilted_ring_cycles(void* out, int steps,
                                           void* stream) {
  tilted_ring_cycles_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
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

// H2 on b planes h x w (tilt_launch) at x, which starts on a 16-byte
// boundary and holds n_x floats, at least b*h*w rounded up to 4: its bulk
// copies read the 16-byte units around each block of rows
extern "C" int gst_haar_tilted_integral(const void* x, void* out, int b,
                                        int h, int w, int cols, int threads,
                                        long long n_x, void* stream) {
  if (b <= 0) return 0;
  const long long n = static_cast<long long>(b) * h * w;
  if ((reinterpret_cast<size_t>(out) & 15) != 0 ||
      (reinterpret_cast<size_t>(x) & 15) != 0 || n_x < ((n + 3) & ~3ll))
    return static_cast<int>(cudaErrorInvalidValue);
  return tilt_launch<false>(static_cast<const float*>(x),
                            static_cast<double*>(out), b, h, w, cols,
                            threads, 1, static_cast<cudaStream_t>(stream));
}
