// Hand-written Hopper kernels of the telecine path: the fieldanalysis
// default metrics (gstbad_tpu_torch/ops/fieldanalysis.py) and the ivtc /
// combdetect comb chain (gstbad_tpu_torch/ops/comb.py).  Plain C entry
// points, loaded with ctypes by gstbad_tpu_torch/ops/_cuda.py; each launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so deinterlace_kernels.cu
//
// Frame indices come from the callers' own plans.  A kernel that finds an
// index outside the pool writes zeros for that frame or pair and reads
// nothing out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// K4: fieldanalysis default metrics.
//
// Replaces gstbad_tpu/ops/fieldanalysis.py:_metrics_kernel.  For each frame
// f of a window, y = pool[cur_idx[f]] and p = pool[prev_idx[f]] (its
// previous valid frame), it sums five exact integer totals:
//   0, 1  ssd on even / odd rows: (y - p)^2 where > nf^2 (every row);
//   2     f:   |y[g-2] - 3y[g-1] + 4y[g] - 3y[g+1] + y[g+2]|,
//   3     t_b: the same tap on interleave(even rows y, odd rows p),
//   4     b_t: the same tap on interleave(even rows p, odd rows y),
//         each where > 6 nf, on even rows g in [2, H-2), plus the mirrored
//         first and last field lines, g = 0 (|2 r2 - 6 r1 + 4 r0|) and
//         g = H-2 (|2 r(H-4) - 6 r(H-3) + 4 r(H-2)|), as
//         opposite_parity_5_tap does.
//
// Bound: device memory.  The window's minimum traffic is one read of every
// distinct frame (y and p overlap: p is mostly the frame before y), about
// 0.92 MB per 1280x720 frame.  Design: the frames are read from the pool
// by index, so no [B, H, W] gather of the previous frames is built.  Grid
// (column block, 32-row band, frame); each thread owns one column of a band
// and slides a five-row register window of y and p down it, so each byte
// is loaded once per band plus a 2-row halo on each side.  The sums are
// reduced per block with warp shuffles and added to the frame's five int64
// totals with one atomicAdd each.  Integer sums make the result exact in
// any order.  The TPU kernel's 4-pixel words and [8, W/4] accumulators are
// not carried over.
// ---------------------------------------------------------------------------

constexpr int kMetricThreads = 128;  // columns per block
constexpr int kMetricRows = 32;      // rows per band

__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int gate(int v, int thr) {
  return v > thr ? v : 0;
}

__global__ void fieldanalysis_metrics_kernel(
    const uint8_t* __restrict__ pool, const int32_t* __restrict__ cur_idx,
    const int32_t* __restrict__ prev_idx, const int32_t* __restrict__ nf_ptr,
    unsigned long long* __restrict__ tot, int P, int H, int W) {
  const int f = blockIdx.z;
  const int ci = cur_idx[f];
  const int pi = prev_idx[f];
  if (ci < 0 || ci >= P || pi < 0 || pi >= P) return;  // uniform per block
  const int nf = *nf_ptr;
  const int nf2 = nf * nf;
  const int nt = nf * 6;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* y = pool + plane * ci;
  const uint8_t* p = pool + plane * pi;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r0 = blockIdx.y * kMetricRows;
  const int r1 = min(r0 + kMetricRows, H);

  long long s_even = 0, s_odd = 0, s_f = 0, s_tb = 0, s_bt = 0;
  if (x < W) {
    auto ld = [&](const uint8_t* q, int r) -> int {
      return (r >= 0 && r < H) ? q[static_cast<size_t>(r) * W + x] : 0;
    };
    int ym2 = ld(y, r0 - 2), ym1 = ld(y, r0 - 1), y0 = ld(y, r0),
        yp1 = ld(y, r0 + 1), yp2 = ld(y, r0 + 2);
    int pm2 = ld(p, r0 - 2), pm1 = ld(p, r0 - 1), p0 = ld(p, r0),
        pp1 = ld(p, r0 + 1), pp2 = ld(p, r0 + 2);
    for (int g = r0; g < r1; ++g) {
      const int d = y0 - p0;
      const int d2 = d * d;
      if (d2 > nf2) {
        if (g & 1) s_odd += d2;
        else s_even += d2;
      }
      if ((g & 1) == 0) {
        int vf, vtb, vbt;
        if (g == 0) {                 // first field line, mirrored taps
          vf = abs(2 * yp2 - 6 * yp1 + 4 * y0);
          vtb = abs(2 * yp2 - 6 * pp1 + 4 * y0);
          vbt = abs(2 * pp2 - 6 * yp1 + 4 * p0);
        } else if (g == H - 2) {      // last field line, mirrored taps
          vf = abs(2 * ym2 - 6 * ym1 + 4 * y0);
          vtb = abs(2 * ym2 - 6 * pm1 + 4 * y0);
          vbt = abs(2 * pm2 - 6 * ym1 + 4 * p0);
        } else if (g < H - 2) {       // interior even row
          vf = abs(ym2 - 3 * ym1 + 4 * y0 - 3 * yp1 + yp2);
          vtb = abs(ym2 - 3 * pm1 + 4 * y0 - 3 * pp1 + yp2);
          vbt = abs(pm2 - 3 * ym1 + 4 * p0 - 3 * yp1 + pp2);
        } else {
          vf = vtb = vbt = 0;
        }
        s_f += gate(vf, nt);
        s_tb += gate(vtb, nt);
        s_bt += gate(vbt, nt);
      }
      ym2 = ym1; ym1 = y0; y0 = yp1; yp1 = yp2; yp2 = ld(y, g + 3);
      pm2 = pm1; pm1 = p0; p0 = pp1; pp1 = pp2; pp2 = ld(p, g + 3);
    }
  }
  const long long s[5] = {s_even, s_odd, s_f, s_tb, s_bt};

  __shared__ long long s_part[kMetricThreads / 32][5];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long v = warp_sum64(s[k]);
    if (lane == 0) s_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    long long v = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
      v += s_part[w][threadIdx.x];
    if (v) atomicAdd(&tot[static_cast<size_t>(f) * 5 + threadIdx.x],
                     static_cast<unsigned long long>(v));
  }
}

// ---------------------------------------------------------------------------
// K5 and K6: the comb chain (gstivtc.c:634-680, gstcombdetect.c:215-260).
//
// Replaces gstbad_tpu/ops/comb.py:_score_kernel (K5, the score of woven
// (top, bottom) pairs read from a frame pool) and
// gstbad_tpu/ops/comb.py:_comb_chain_kernel (K6, the per-pixel over-100
// mask and score of whole frames).  One template, two instantiations.
//
// For rows j = 2 .. H-3 of the woven frame il (even rows from the top
// frame, odd rows from the bottom one), a cell is an outlier when
// il[j][x] < min(il[j-1][x], il[j+1][x]) - 5 or > max + 5.  Row by row,
// seg[x] = outlier ? seg[x-1] + p[x] + 1 : 0 is a segmented prefix sum of
// p + 1 over the outlier runs, with p the previous row's seg clamped at
// 1000; a cell scores when seg > 100.  Clamping only the carried row is
// exact: a clamped value is > 100 either way, and min(seg, 1000) equals
// the reference's clamped cell (comb.py's module note).
//
// Bound: latency.  The minimum traffic is one read of each woven frame
// (and, for K6, one write of its mask), but row j needs row j - 1's
// result across the whole width, so each chain is H - 4 dependent steps.
// Design: one block per chain walks the rows in order, keeping its carried
// row in registers: each thread owns a contiguous run of up to
// kCombMaxCols columns.  Per row a thread scans its own columns, the block
// scans the threads' (no reset seen, trailing sum) pairs with warp shuffles
// and one shared-memory step, and each thread adds its carry-in to its
// leading run.  Two barriers per row; the shared pairs are double-buffered
// by row parity.  Chains are independent blocks, so a window's chains run
// side by side on the SMs.  Nothing is staged: the woven rows are read
// straight from the pool (K5) or the frame (K6), and the TPU kernels'
// [rows, 32 chains, W] staging and lane rolls are not carried over.
// ---------------------------------------------------------------------------

constexpr int kCombMaxCols = 8;
constexpr int kCombMaxThreads = 1024;

struct Seg {
  int open;  // no reset (non-outlier) inside the span
  int sum;   // the span's trailing run sum, with a carry-in of 0
};

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {  // a left of b
  return Seg{a.open & b.open, b.open ? a.sum + b.sum : b.sum};
}

__device__ __forceinline__ bool outlier(int a, int b, int c) {
  return b < min(a, c) - 5 || b > max(a, c) + 5;
}

// score[n] = count of cells > 100 of chain n; kMask also writes
// mask[n] ([H, W] bytes 0/1, 0 outside rows 2 .. H-3).  Chain n weaves
// pool[top[n]] (even rows) and pool[bot[n]] (odd rows); with top == null it
// is the frame pool[n] itself.
template <bool kMask>
__global__ void __launch_bounds__(kCombMaxThreads)
comb_chain_kernel(const uint8_t* __restrict__ pool,
                  const int32_t* __restrict__ top,
                  const int32_t* __restrict__ bot, int P, int H, int W,
                  int cols, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ score) {
  __shared__ int s_open[2][32];
  __shared__ int s_sum[2][32];
  __shared__ int s_count[32];

  const int n = blockIdx.x;
  const int ti = top ? top[n] : n;
  const int bi = top ? bot[n] : n;
  const bool ok = ti >= 0 && ti < P && bi >= 0 && bi < P;  // uniform
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* ft = pool + plane * (ok ? ti : 0);
  const uint8_t* fb = pool + plane * (ok ? bi : 0);
  uint8_t* mk = kMask ? mask + plane * n : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int x0 = tid * cols;
  const int ncol = max(0, min(cols, W - x0));

  if (kMask) {  // rows outside the scanned band (all rows when H < 5)
    for (int r = 0; r < H; ++r) {
      if (r >= 2 && r < H - 2 && ok) continue;
      for (int i = 0; i < ncol; ++i)
        mk[static_cast<size_t>(r) * W + x0 + i] = 0;
    }
  }
  if (!ok) {
    if (tid == 0) score[n] = 0;
    return;
  }

  auto row = [&](int r) -> const uint8_t* {
    return ((r & 1) ? fb : ft) + static_cast<size_t>(r) * W + x0;
  };
  int carry[kCombMaxCols];
  int above[kCombMaxCols], cur[kCombMaxCols];
#pragma unroll
  for (int i = 0; i < kCombMaxCols; ++i) {
    carry[i] = 0;
    above[i] = cur[i] = 0;
  }
  if (H >= 5) {
    const uint8_t* r1 = row(1);
    const uint8_t* r2 = row(2);
#pragma unroll
    for (int i = 0; i < kCombMaxCols; ++i) {
      if (i < ncol) {
        above[i] = r1[i];
        cur[i] = r2[i];
      }
    }
  }
  int count = 0;

  for (int j = 2; j < H - 2; ++j) {
    const uint8_t* rn = row(j + 1);
    int below[kCombMaxCols];
    bool m[kCombMaxCols];
    // 1-2: outlier bits and the thread-local segmented scan (carry-in 0)
    Seg mine{1, 0};
#pragma unroll
    for (int i = 0; i < kCombMaxCols; ++i) {
      below[i] = i < ncol ? rn[i] : 0;
      m[i] = i < ncol && outlier(above[i], cur[i], below[i]);
      if (i < ncol) {
        if (m[i]) {
          mine.sum += carry[i] + 1;
        } else {
          mine.sum = 0;
          mine.open = 0;
        }
      }
    }
    // 3: block-wide exclusive scan of the threads' pairs
    Seg v = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Seg u{__shfl_up_sync(kFull, v.open, o), __shfl_up_sync(kFull, v.sum, o)};
      if (lane >= o) v = seg_combine(u, v);
    }
    Seg excl{__shfl_up_sync(kFull, v.open, 1),
             __shfl_up_sync(kFull, v.sum, 1)};
    if (lane == 0) excl = Seg{1, 0};
    const int buf = j & 1;
    if (lane == 31) {
      s_open[buf][warp] = v.open;
      s_sum[buf][warp] = v.sum;
    }
    __syncthreads();
    if (warp == 0) {
      Seg w = lane < nwarps ? Seg{s_open[buf][lane], s_sum[buf][lane]}
                            : Seg{1, 0};
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        Seg u{__shfl_up_sync(kFull, w.open, o),
              __shfl_up_sync(kFull, w.sum, o)};
        if (lane >= o) w = seg_combine(u, w);
      }
      s_open[buf][lane] = w.open;  // inclusive over warps 0 .. lane
      s_sum[buf][lane] = w.sum;
    }
    __syncthreads();
    Seg before = warp ? Seg{s_open[buf][warp - 1], s_sum[buf][warp - 1]}
                      : Seg{1, 0};
    // 4-5: the same scan again from the carry-in (it joins the leading
    // run only); score; clamp the carried row
    int run = seg_combine(before, excl).sum;
#pragma unroll
    for (int i = 0; i < kCombMaxCols; ++i) {
      if (i < ncol) {
        run = m[i] ? run + carry[i] + 1 : 0;
        const bool over = run > 100;
        count += over;
        if (kMask) mk[static_cast<size_t>(j) * W + x0 + i] = over;
        carry[i] = min(run, 1000);
        above[i] = cur[i];
        cur[i] = below[i];
      }
    }
  }

  // the chain's score: a block sum of the threads' counts
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(kFull, count, o);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += s_count[w];
    score[n] = total;
  }
}

// threads and columns per thread for a width: about 256 threads, at most
// kCombMaxCols columns each; 0 when the width is too large
int comb_threads(int W, int* cols) {
  int c = (W + 255) / 256;
  if (c < 1) c = 1;
  if (c > kCombMaxCols) c = kCombMaxCols;
  int t = (W + c - 1) / c;
  t = ((t + 31) / 32) * 32;
  if (t > kCombMaxThreads) return 0;
  *cols = c;
  return t;
}

}  // namespace

extern "C" int gst_fieldanalysis_metrics(const void* pool, const void* cur_idx,
                                         const void* prev_idx, const void* nf,
                                         void* tot, int P, int B, int H,
                                         int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kMetricThreads - 1) / kMetricThreads,
                  (H + kMetricRows - 1) / kMetricRows, B);
  fieldanalysis_metrics_kernel<<<grid, kMetricThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(cur_idx),
      static_cast<const int32_t*>(prev_idx),
      static_cast<const int32_t*>(nf),
      static_cast<unsigned long long*>(tot), P, H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_comb_score_pairs(const void* pool, const void* top_idx,
                                    const void* bot_idx, void* score, int P,
                                    int N, int H, int W, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  int cols = 1;
  const int threads = comb_threads(W, &cols);
  if (!threads) return static_cast<int>(cudaErrorInvalidValue);
  comb_chain_kernel<false><<<N, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(top_idx),
      static_cast<const int32_t*>(bot_idx), P, H, W, cols, nullptr,
      static_cast<int32_t*>(score));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_comb_mask(const void* luma, void* mask, void* score, int N,
                             int H, int W, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  int cols = 1;
  const int threads = comb_threads(W, &cols);
  if (!threads) return static_cast<int>(cudaErrorInvalidValue);
  comb_chain_kernel<true><<<N, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(luma), nullptr, nullptr, N, H, W, cols,
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(score));
  return static_cast<int>(cudaGetLastError());
}
