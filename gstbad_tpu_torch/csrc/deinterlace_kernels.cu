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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// K4: fieldanalysis default metrics.
//
// Replaces gstbad_tpu/ops/fieldanalysis.py:_metrics_kernel.  For each frame
// f of a window, y = pool[cur_idx[f]] and p = pool[prev_idx[f]] (its
// previous valid frame), it sums five exact integer totals:
//   t, b  ssd on even / odd rows: (y - p)^2 where > nf^2 (every row);
//   f     |y[g-2] - 3y[g-1] + 4y[g] - 3y[g+1] + y[g+2]|,
//   t_b   the same tap on interleave(even rows y, odd rows p),
//   b_t   the same tap on interleave(even rows p, odd rows y),
//         each where > 6 nf, on even rows g in [2, H-2), plus the mirrored
//         first and last field lines, g = 0 (rows g-2, g-1 read as g+2,
//         g+1) and g = H-2 (rows g+1, g+2 read as g-1, g-2), as
//         opposite_parity_5_tap does;
// and writes them normalised, out[k][f] = float(total) * (1 / norm) in
// float32 round-to-nearest, as ops/fieldanalysis.py:_normalise does (norm
// 3WH for f, t_b, b_t and WH/2 for t, b), in the order (f, t, b, t_b, b_t).
//
// Bound: the INT32 pipe at the main path's shape.  The least is 29/4
// instructions a pixel of each frame, with bytes packed four and 16-bit
// values two to an instruction (chip_smoke.py lists them): 0.051 ms for
// config 5's 128 frames on an H100 (132 SMs at 1980 MHz), above one read
// of every distinct frame (y and p overlap: p is mostly the frame before
// y), 0.92 MB per 1280x720 frame, 0.036 ms at 3.35 TB/s.
//
// Design: packed integer lanes, as that count assumes.
// - A thread walks 8 columns down a band of about kMetricBandRows rows,
//   two rows a step (one even, one odd), so a row's parity is static: the
//   ssd of each row goes to its own sum and the taps run once a step, with
//   no branch in the loop.  The mirrored first and last field lines are
//   the band's first and last steps, peeled out of the loop.  A row is
//   one 8-byte load per frame where W % 8 == 0 (byte loads otherwise),
//   loaded two steps ahead of its use: with the loads one step ahead,
//   their latency and not the instructions held the kernel.  The band
//   re-reads 2 rows above it and 1 below (2% at 720p).
// - ssd: |y - p| on four bytes at once (vabsdiff4); the gate d^2 > nf^2
//   is d >= t1 per byte, t1 = isqrt(nf^2) + 1 (0 when nf^2 wrapped below
//   0, none when nf^2 >= 255^2), a borrow-free byte compare whose top
//   bits a byte permute spreads into a mask; dp4a squares and adds.
// - taps: each row unpacked once into two 16-bit lanes a word; with
//   E = r[g-2] + 4 r[g] + r[g+2] and O3 = 3 (r[g-1] + r[g+1]) of y and of
//   p (at most 1530, no lane carries), f = |Ey - O3y|, t_b = |Ey - O3p|,
//   b_t = |Ep - O3y| (16x2 max - min).  The gate v > 6 nf (6 nf clamped to
//   [-1, 1530], its int32 wrap kept) is bit 15 of v + 0x7fff - 6 nf, a
//   byte permute turns it into -1 / 0 bytes, and dp2a adds -v of the
//   lanes that pass.
// - Sums: int32 a band (at most 8 x 192 x 255^2 < 2^31), int64 a thread.
//   Each frame is one cluster of kMetricCluster blocks; their sums meet
//   in block 0's shared memory (distributed shared memory), which
//   normalises and writes them: no atomics, no zero fill, no launch after.
// ---------------------------------------------------------------------------

constexpr int kMetricCluster = 8;      // blocks per frame (one cluster)
constexpr int kMetricMaxThreads = 256;
constexpr int kMetricBandRows = 128;   // rows a band, about

__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// a byte permute in PTX's default mode: a selector nibble with its top bit
// set spreads the top bit of the byte it picks over the result byte
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// |a - b| on two unsigned 16-bit lanes: max - min (Hopper's 16x2 min and
// max, one instruction each; no lane borrows).  sm_90 has no instruction
// for __vabsdiffu2, which nvcc emulates.
__device__ __forceinline__ uint32_t absdiff_u16x2(uint32_t a, uint32_t b) {
  uint32_t hi, lo;
  asm("max.u16x2 %0, %1, %2;" : "=r"(hi) : "r"(a), "r"(b));
  asm("min.u16x2 %0, %1, %2;" : "=r"(lo) : "r"(a), "r"(b));
  return hi - lo;
}

// 8 pixels of row r (columns x0 .. x0+7) as two words, bytes past W as 0;
// kVec: one 8-byte load (W % 8 == 0 and an 8-byte aligned pool)
template <bool kVec>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ q,
                                         int r, int x0, int W,
                                         uint32_t (&w)[2]) {
  const uint8_t* s = q + static_cast<size_t>(r) * W + x0;
  if (kVec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(s));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + 4 * j + k < W)
          v |= static_cast<uint32_t>(__ldg(s + 4 * j + k)) << (8 * k);
      w[j] = v;
    }
  }
}

// one frame's walk of its bands; the tap sums are kept negated (dp2a
// adds -v for each lane that passes)
template <bool kVec>
struct MetricWalk {
  const uint8_t* y;
  const uint8_t* p;
  int H, W, x0;
  uint32_t t1, t1_lo, t1_not, on, K;
  // the window: rows g-2, g-1, g of y and p in 16-bit lanes (bytes 0, 2
  // and 1, 3 of each word); this step's rows g+1, g+2 as loaded (r*), and
  // the next step's (n*), in flight
  uint32_t ym2[4], ym1[4], y0[4], pm2[4], pm1[4], p0[4];
  uint32_t ry1[2], rp1[2], ry2[2], rp2[2];
  uint32_t ny1[2], np1[2], ny2[2], np2[2];
  uint32_t a_even, a_odd;
  int a_f, a_tb, a_bt;

  __device__ __forceinline__ uint32_t ssd(const uint32_t (&yw)[2],
                                          const uint32_t (&pw)[2],
                                          uint32_t acc) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t d = __vabsdiffu4(yw[j], pw[j]);
      // top bit of each byte: d >= t1 (no borrow crosses a byte)
      const uint32_t x = (d | 0x80808080u) - t1_lo;
      const uint32_t ge = (d & t1_not) | (~(d ^ t1) & x);
      const uint32_t dm = d & prmt(ge, 0u, 0xBA98u) & on;
      acc = __dp4a(dm, dm, acc);
    }
    return acc;
  }

  static __device__ __forceinline__ void lanes(const uint32_t (&w)[2],
                                               uint32_t (&l)[4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[2 * j] = prmt(w[j], 0u, 0x4240u);
      l[2 * j + 1] = prmt(w[j], 0u, 0x4341u);
    }
  }

  __device__ __forceinline__ int gate(uint32_t v, int acc) const {
    return __dp2a_lo(static_cast<int>(v),
                     static_cast<int>(prmt(v + K, 0u, 0x44B9u)), acc);
  }

  // row r into the window's lanes; kSsd: its ssd into the even sum
  template <bool kSsd>
  __device__ __forceinline__ void first_row(int r, uint32_t (&yl)[4],
                                            uint32_t (&pl)[4]) {
    uint32_t yw[2], pw[2];
    load_row<kVec>(y, r, x0, W, yw);
    load_row<kVec>(p, r, x0, W, pw);
    if (kSsd) a_even = ssd(yw, pw, a_even);
    lanes(yw, yl);
    lanes(pw, pl);
  }

  // rows g+1 and g+2 for the step at g into n*, clamped to the last row
  // (the last field line's step reads no row below it, and the last
  // step's fetch is for a step that does not come)
  __device__ __forceinline__ void fetch(int g) {
    const int r1 = min(g + 1, H - 1);
    load_row<kVec>(y, r1, x0, W, ny1);
    load_row<kVec>(p, r1, x0, W, np1);
    const int r2 = min(g + 2, H - 1);
    load_row<kVec>(y, r2, x0, W, ny2);
    load_row<kVec>(p, r2, x0, W, np2);
  }

  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ry1[j] = ny1[j];
      rp1[j] = np1[j];
      ry2[j] = ny2[j];
      rp2[j] = np2[j];
    }
  }

  // the step at even row g: the ssd of rows g+1 (and g+2 when it lies in
  // the band), the three taps at g, then the window slides two rows.
  // kTop: g = 0; kBottom: g = H-2 (no row g+2); kNext: take the next
  // step's rows and fetch those of the step after it, so that each load
  // has two steps to arrive
  template <bool kTop, bool kBottom, bool kSsdEven, bool kNext>
  __device__ __forceinline__ void step(int g) {
    a_odd = ssd(ry1, rp1, a_odd);
    if (kSsdEven) a_even = ssd(ry2, rp2, a_even);
    uint32_t y1[4], p1[4], y2[4], p2[4];
    lanes(ry1, y1);
    lanes(rp1, p1);
    lanes(ry2, y2);
    lanes(rp2, p2);
    if (kNext) {
      advance();
      fetch(g + 4);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t y1k = kBottom ? ym1[k] : y1[k];
      const uint32_t p1k = kBottom ? pm1[k] : p1[k];
      const uint32_t y2k = kBottom ? ym2[k] : y2[k];
      const uint32_t p2k = kBottom ? pm2[k] : p2[k];
      const uint32_t ym1k = kTop ? y1k : ym1[k];
      const uint32_t pm1k = kTop ? p1k : pm1[k];
      const uint32_t ym2k = kTop ? y2k : ym2[k];
      const uint32_t pm2k = kTop ? p2k : pm2[k];
      const uint32_t ey = ym2k + y2k + (y0[k] << 2);
      const uint32_t ep = pm2k + p2k + (p0[k] << 2);
      const uint32_t oy = (ym1k + y1k) * 3u;
      const uint32_t op = (pm1k + p1k) * 3u;
      a_f = gate(absdiff_u16x2(ey, oy), a_f);
      a_tb = gate(absdiff_u16x2(ey, op), a_tb);
      a_bt = gate(absdiff_u16x2(ep, oy), a_bt);
      ym2[k] = y0[k];
      pm2[k] = p0[k];
      ym1[k] = y1[k];
      pm1[k] = p1[k];
      y0[k] = y2[k];
      p0[k] = p2[k];
    }
  }

  // rows [r0, r1) of the 8 columns at x0 (r0, r1 even)
  __device__ __forceinline__ void band(int r0, int r1) {
    a_even = a_odd = 0u;
    a_f = a_tb = a_bt = 0;
    int g = r0;
    if (r0 == 0) {          // the first field line; r1 >= 4
      first_row<true>(0, y0, p0);
      fetch(0);
      advance();
      fetch(2);
      step<true, false, true, true>(0);
      g = 2;
    } else {
      first_row<false>(r0 - 2, ym2, pm2);
      first_row<false>(r0 - 1, ym1, pm1);
      first_row<true>(r0, y0, p0);
      fetch(r0);
      advance();
      fetch(r0 + 2);
    }
#pragma unroll 2
    for (; g + 2 < r1; g += 2) step<false, false, true, true>(g);
    if (r1 == H)            // the last field line
      step<false, true, false, false>(g);
    else                    // row r1 is the next band's
      step<false, false, false, false>(g);
  }
};

template <bool kVec>
__global__ void __cluster_dims__(kMetricCluster, 1, 1)
    __launch_bounds__(kMetricMaxThreads)
    fieldanalysis_metrics_kernel(const uint8_t* __restrict__ pool,
                                 const int32_t* __restrict__ cur_idx,
                                 const int32_t* __restrict__ prev_idx,
                                 const int32_t* __restrict__ nf_ptr,
                                 float* __restrict__ out, int P, int B,
                                 int H, int W, int R, int nbands) {
  namespace cg = cooperative_groups;
  const int f = blockIdx.y;
  const unsigned rank = blockIdx.x;   // the grid is one cluster wide
  const int ci = cur_idx[f];
  const int pi = prev_idx[f];
  if (ci < 0 || ci >= P || pi < 0 || pi >= P) {   // uniform per cluster
    if (rank == 0 && threadIdx.x < 5) out[threadIdx.x * B + f] = 0.0f;
    return;
  }
  // the gates, from nf's int32 products as the plain version forms them
  const uint32_t nfu = static_cast<uint32_t>(*nf_ptr);
  const int nf2 = static_cast<int>(nfu * nfu);
  const int nt = static_cast<int>(nfu * 6u);
  uint32_t t1 = 0u, on = kFull;
  if (nf2 >= 255 * 255) {
    on = 0u;
  } else if (nf2 >= 0) {
    int s = static_cast<int>(sqrtf(static_cast<float>(nf2)));
    while (s * s > nf2) --s;
    while ((s + 1) * (s + 1) <= nf2) ++s;
    t1 = static_cast<uint32_t>(s + 1);
  }
  const int ntc = min(max(nt, -1), 1530);

  MetricWalk<kVec> w;
  const size_t plane = static_cast<size_t>(H) * W;
  w.y = pool + plane * ci;
  w.p = pool + plane * pi;
  w.H = H;
  w.W = W;
  w.t1 = t1 * 0x01010101u;
  w.t1_lo = w.t1 & 0x7f7f7f7fu;
  w.t1_not = ~w.t1;
  w.on = on;
  w.K = static_cast<uint32_t>(0x7fff - ntc) * 0x00010001u;

  long long s[5] = {0, 0, 0, 0, 0};   // f, t, b, t_b, b_t
  const long long G = (W + 7) >> 3;
  const long long items = G * nbands;
  for (long long it = rank * blockDim.x + threadIdx.x; it < items;
       it += kMetricCluster * blockDim.x) {
    const int band = static_cast<int>(it / G);
    w.x0 = static_cast<int>(it - band * G) << 3;
    const int r0 = band * R;
    w.band(r0, min(r0 + R, H));
    s[0] -= w.a_f;
    s[1] += w.a_even;
    s[2] += w.a_odd;
    s[3] -= w.a_tb;
    s[4] -= w.a_bt;
  }

  __shared__ long long part[kMetricMaxThreads / 32][5];
  __shared__ long long block_sum[5];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const long long v = warp_sum64(s[k]);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    long long v = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i)
      v += part[i][threadIdx.x];
    block_sum[threadIdx.x] = v;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0 && threadIdx.x < 5) {
    long long v = 0;
    for (int r = 0; r < kMetricCluster; ++r)
      v += cluster.map_shared_rank(block_sum, r)[threadIdx.x];
    const double hw = static_cast<double>(H) * W;
    const double norm = threadIdx.x == 1 || threadIdx.x == 2 ? 0.5 * hw
                                                             : 3.0 * hw;
    const float recip = __fdiv_rn(1.0f, __double2float_rn(norm));
    out[threadIdx.x * B + f] = __fmul_rn(__ll2float_rn(v), recip);
  }
  cluster.sync();   // block 0 has read every block's sums
}

// ---------------------------------------------------------------------------
// K5 and K6: the comb chain (gstivtc.c:634-680, gstcombdetect.c:215-260).
//
// Replaces gstbad_tpu/ops/comb.py:_score_kernel (K5, the score of woven
// (top, bottom) pairs read from a frame pool) and
// gstbad_tpu/ops/comb.py:_comb_chain_kernel (K6, the per-pixel over-100
// mask and score of whole frames).  One template; kMask selects K6.
//
// For rows j = 2 .. H-3 of the woven frame il (even rows from the top
// frame, odd rows from the bottom one), a cell is an outlier when
// il[j][x] < min(il[j-1][x], il[j+1][x]) - 5 or > max + 5.  Row by row,
// seg[x] = outlier ? seg[x-1] + p[x] + 1 : 0, with p the previous row's
// seg clamped at 1000; a cell scores when seg > 100.  Clamping only the
// carried row is exact: a clamped value is > 100 either way, and
// min(seg, 1000) equals the reference's clamped cell (comb.py's module
// note).
//
// Bound, at the main paths' shapes: K6 by device memory (a byte read and
// a mask byte written a cell), K5 by the INT32 pipe (its pairs reuse the
// pool's frames, so it reads less than a byte a cell).  The least is 18/4
// instructions a cell, 19/4 for K6's mask, with bytes packed four and
// 16-bit values two to an instruction (chip_smoke.py lists them: the
// outlier test on bytes, the recurrence in 16-bit lanes, as a run clamped
// at 1000 in the row scores as the unclamped one).  Down a column, cell
// (j, x) needs (j - 1, x) through one dependent step (the clamp of the
// carried cell, the select and the add; comb_row_cycles_kernel measures
// it): the chain bound that chip_smoke.py takes is H - 4 such steps, a
// few microseconds at 720p, below both.  Along a row,
// cell (j, x) also needs (j, x - 1): a scan across the row shortens that
// part to a few shuffle latencies, while this kernel's wavefront walks it,
// so its own chain is H - 4 rows plus W - 1 columns of steps (about
// 4.6 us at 720p), still below both.  A design that finishes a row
// across the whole width before it starts the next puts a warp-wide scan
// (six shuffle latencies) and a hand-over between warps on the critical
// path of every one of the H - 4 rows; this one pipelines the rows
// instead.
//
// Design: one block of kCombWarps warps per chain, split by role.
// - Walker warps (the first nw: about kCombLaneCols columns a lane, and
//   at most one warp for each of the SM's four schedulers) walk the
//   cells.  Lane g of walker warp w owns C consecutive columns (C = 16,
//   32 or 64) and keeps their carried row in registers.  The lanes
//   run as a wavefront: at step t the lane takes row
//   t - (w * (32 + kCombLag) + g), so the run entering its columns in that
//   row is what the lane before left there one step earlier: one
//   __shfl_up_sync a step, then C dependent cell steps.  Lane 0 of a later
//   warp takes it instead from the (row, run) word that lane 31 of the
//   warp before posted to shared memory kCombLag steps earlier, so the
//   warps do not wait on each other; it polls only when that warp has
//   fallen behind.  No row waits for a scan of the whole width: a chain
//   takes H - 4 steps plus the span of the wavefront (comb_span).  The
//   next step's bits and post are read a step ahead.  K6's lanes store
//   their mask bytes themselves, 16 at a time where W allows.
// - Producer warps (the rest) take the frames off the walk.  The outlier
//   bit of a cell needs no carry, so they turn kCombRows rows at a time
//   into bits ahead of the walk, into a shared-memory ring deep enough for
//   the rows the wavefront spans (comb_stages): a thread takes 8 columns,
//   loads the chunk's rows (and the ones above and below it) with one
//   8-byte load each, all at once, compares two bytes at a time in 16-bit
//   lanes and writes a byte of bits a row.  They also zero K6's rows
//   outside the band.  Walkers and producers meet at one barrier per
//   kCombRows steps.
// The TPU kernels' [rows, 32 chains, W] staging and lane rolls are not
// carried over.
// ---------------------------------------------------------------------------

constexpr int kCombRows = 16;          // rows per chunk of the bit ring
constexpr int kCombLag = 4;            // steps a warp trails the one before
constexpr int kCombWarps = 12;         // warps per chain: walkers, producers
constexpr int kCombSchedulers = 4;     // an SM's warp schedulers; walker
                                       // warps per chain, at most
constexpr int kCombMaxCols = 64;       // columns per walker lane, at most
constexpr int kCombLaneCols = 16;      // columns per lane comb_walkers aims at
constexpr int kCombThreads = 32 * kCombWarps;
constexpr int kCombPosts = 64;         // rows of the warps' hand-over ring
// dynamic shared memory a block may take: 227 KB less the static arrays
constexpr size_t kCombSmemLimit = 232448 - 8192;

// A lane's bits, one per column: bit i is column x0 + i.
template <int C>
using CombBits = typename std::conditional<(C <= 32), uint32_t,
                                           unsigned long long>::type;

__device__ __forceinline__ int popc_of(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popc_of(unsigned long long v) {
  return __popcll(v);
}

// The outlier bits of the four bytes of b between a (above) and c
// (below), as bits 0..3.  Two bytes at a time sit in 16-bit lanes with a
// guard bit, so that 512 + x - y - 6 (never below 0 nor above 1023) has
// bit 9 set exactly when x - y >= 6: b < min(a, c) - 5 is a - b >= 6 and
// c - b >= 6; b > max(a, c) + 5 is b - a >= 6 and b - c >= 6.
__device__ __forceinline__ uint32_t outlier_nibble(uint32_t a, uint32_t b,
                                                   uint32_t c) {
  constexpr uint32_t kLanes = 0x00FF00FFu, kGuard = 0x02000200u;
  constexpr uint32_t kSix = 0x00060006u;
  uint32_t f[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // bytes 0 and 2, then 1 and 3
    const uint32_t x = (a >> (8 * h)) & kLanes;
    const uint32_t y = (b >> (8 * h)) & kLanes;
    const uint32_t z = (c >> (8 * h)) & kLanes;
    const uint32_t below =
        ((x | kGuard) - y - kSix) & ((z | kGuard) - y - kSix);
    const uint32_t above =
        ((y | kGuard) - x - kSix) & ((y | kGuard) - z - kSix);
    f[h] = (below | above) & kGuard;   // bits 9 and 25
  }
  const uint32_t m = (f[0] >> 9) | (f[1] >> 8);   // bits 0, 1, 16, 17
  return (m | (m >> 14)) & 0xFu;
}

// Bytes x .. x+7 of a row, 0 past W: one aligned 8-byte load when kVec
// (W % 8 == 0 and an aligned pool), else byte by byte.
template <bool kVec>
__device__ __forceinline__ uint2 load8(const uint8_t* p, int x, int W) {
  if (kVec) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t v[2] = {0, 0};
#pragma unroll 1
  for (int k = 0; k < 8 && x + k < W; ++k)
    v[k >> 2] |= static_cast<uint32_t>(__ldg(p + k)) << (8 * (k & 3));
  return make_uint2(v[0], v[1]);
}

// The outlier bits of rows j0 .. j0+rows-1 (rows <= kCombRows) into
// bits[r * pitch + k], word k holding columns 32k .. 32k+31 (bits past W
// may be set).  Run by the producer threads, pt of np: a thread takes 8
// columns, loads the chunk's rows and the one above and below it all at
// once (one trip to memory a chunk), and writes one byte of bits a row.
template <bool kVec>
__device__ __noinline__ void comb_outlier_rows(const uint8_t* ft,
                                               const uint8_t* fb, int W,
                                               int j0, int rows,
                                               uint32_t* bits, int pitch,
                                               int pt, int np) {
  uint8_t* bytes = reinterpret_cast<uint8_t*>(bits);   // 8 columns a byte
  const int groups = (W + 7) >> 3;   // of 8 columns
  for (int q = pt; q < groups; q += np) {
    const int x = 8 * q;
    const uint32_t cols = W - x >= 8 ? 0xFFu : (1u << (W - x)) - 1;
    uint2 v[kCombRows + 2];
#pragma unroll
    for (int r = 0; r < kCombRows + 2; ++r) {
      const int y = j0 - 1 + r;
      v[r] = r < rows + 2 ? load8<kVec>(((y & 1) ? fb : ft) +
                                            static_cast<size_t>(y) * W + x,
                                        x, W)
                          : make_uint2(0, 0);
    }
#pragma unroll
    for (int r = 0; r < kCombRows; ++r) {
      if (r < rows) {
        const uint32_t lo = outlier_nibble(v[r].x, v[r + 1].x, v[r + 2].x);
        const uint32_t hi = outlier_nibble(v[r].y, v[r + 1].y, v[r + 2].y);
        bytes[r * 4 * pitch + q] =
            static_cast<uint8_t>((lo | (hi << 4)) & cols);
      }
    }
  }
}

// comb_outlier_rows with the chain's load width.
__device__ __forceinline__ void comb_outlier_rows(const uint8_t* ft,
                                                  const uint8_t* fb, int W,
                                                  bool vec, int j0, int rows,
                                                  uint32_t* bits, int pitch,
                                                  int pt, int np) {
  if (vec)
    comb_outlier_rows<true>(ft, fb, W, j0, rows, bits, pitch, pt, np);
  else
    comb_outlier_rows<false>(ft, fb, W, j0, rows, bits, pitch, pt, np);
}

// Four bits to four bytes of 0 or 1.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// A lane's C bits of one bit row, from word wq on, shifted by sh.
template <int C>
__device__ __forceinline__ CombBits<C> comb_lane_bits(const uint32_t* row,
                                                      int wq, int sh) {
  const uint32_t lo = __funnelshift_r(row[wq], row[wq + 1], sh);
  if constexpr (C <= 32) {
    return C == 32 ? lo : lo & ((1u << C) - 1);
  } else {
    const uint32_t hi = __funnelshift_r(row[wq + 1], row[wq + 2], sh);
    const unsigned long long v =
        (static_cast<unsigned long long>(hi) << 32) | lo;
    if constexpr (C == 64) return v;
    else return v & ((1ull << C) - 1);
  }
}

// One lane's C cells of one row: run is the run entering them; a[i] is the
// carried seg of cell i plus 1, on entry and, for the next row, on return.
// Returns the cells over 100 and leaves the run leaving them in run.
template <int C>
__device__ __forceinline__ CombBits<C> comb_cells(int (&a)[C], CombBits<C> b,
                                                  int& run) {
  using Bits = CombBits<C>;
  Bits over = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    run = (b >> i) & 1 ? run + a[i] : 0;
    if (run > 100) over |= Bits(1) << i;
    a[i] = min(run + 1, 1001);
  }
  return over;
}

// The block's barrier 0, which walkers and producers reach from their own
// loops, whole warps at a time, the same number of times.
__device__ __forceinline__ void comb_barrier() {
  asm volatile("bar.sync 0;" ::: "memory");
}

// What a chain's warps share.
struct CombChain {
  const uint8_t* ft;        // top frame (even rows)
  const uint8_t* fb;        // bottom frame (odd rows)
  uint8_t* mk;              // K6: the chain's mask; null for K5
  int W, nw;
  bool vec8, vec16;         // 8-byte frame loads; 16-byte mask stores
  int pitch, stages;        // words per bit row; chunks in the ring
  uint32_t* bits;           // [stages][kCombRows][pitch]
  long long* post;          // [kCombPosts][kCombSchedulers]
  int nrows, nchunks;       // rows 2 .. H-3, in chunks of kCombRows
  int nsteps;               // chunks of kCombRows wavefront steps
};

// A walker warp's lanes: the wavefront, kCombRows steps between
// barriers.  Lane g of warp w takes row t - (w * (32 + kCombLag) + g) at
// step t: what it needs from the warp before was posted kCombLag steps
// earlier, so it waits only when that warp falls behind.  Returns the
// lane's count of cells over 100.
template <int C, bool kMask>
__device__ __forceinline__ int comb_walk(const CombChain& ch, int warp,
                                         int lane) {
  using Bits = CombBits<C>;
  const int x0 = (32 * warp + lane) * C;
  const int wq = x0 >> 5;
  const int sh = x0 & 31;
  // the lane's columns inside the frame (a byte of the ring may hold bits
  // past W)
  const Bits cols = x0 >= ch.W ? 0
                    : ch.W - x0 >= C ? ~Bits(0)
                                     : (Bits(1) << (ch.W - x0)) - 1;
  volatile long long* post = ch.post;
  int row = -(warp * (32 + kCombLag) + lane);   // walk row (frame row + 2)
  // the ring row of `row`, kept without a division: rows sit at row % ring
  const int ring = ch.stages * kCombRows;
  int slot = (ring + row % ring) % ring;
  int a[C];
#pragma unroll
  for (int i = 0; i < C; ++i) a[i] = 1;
  // this row's bits, and (lane 0) the warp before's post for it: both
  // read a step ahead, inside a chunk
  auto bits_of = [&](int r) -> Bits {
    return r >= 0 && r < ch.nrows && cols
               ? comb_lane_bits<C>(ch.bits + slot * ch.pitch, wq, sh) & cols
               : Bits(0);
  };
  auto post_of = [&](int r) -> volatile long long* {
    return post + (r & (kCombPosts - 1)) * kCombSchedulers + warp - 1;
  };
  const bool reads_post = lane == 0 && warp > 0;
  int run = 0;
  int count = 0;
  for (int c = 0; c < ch.nsteps; ++c) {
    Bits b = bits_of(row);
    long long p = reads_post ? *post_of(row) : 0;
    for (int s = 0; s < kCombRows; ++s) {
      const bool live = row >= 0 && row < ch.nrows;
      // the run entering this lane's columns in this row: what the lane
      // before left there one step ago
      int in = __shfl_up_sync(kFull, run, 1);
      // lane 0 of a later warp: posted kCombLag steps ago as a rule, so
      // poll only when it is not (a polling loop costs the warp its turn
      // at every round)
      const bool wait = reads_post && live;
      if (__any_sync(kFull, wait && static_cast<int>(p >> 32) != row)) {
        if (wait) {
          while (static_cast<int>(p >> 32) != row) p = *post_of(row);
        }
      }
      if (lane == 0) in = wait ? static_cast<int>(p) : 0;
      run = in;
      const Bits over = comb_cells<C>(a, b, run);
      if (lane == 31 && warp + 1 < ch.nw && live)
        post[(row & (kCombPosts - 1)) * kCombSchedulers + warp] =
            (static_cast<long long>(row) << 32) | static_cast<uint32_t>(run);
      if (live) {
        count += popc_of(over);
        if (kMask && cols) {
          uint8_t* dst = ch.mk + static_cast<size_t>(row + 2) * ch.W + x0;
          if (ch.vec16) {   // 16 cells a store
#pragma unroll
            for (int k = 0; k < C / 16; ++k) {
              if (x0 + 16 * k < ch.W) {
                const uint32_t o = static_cast<uint32_t>(over >> (16 * k));
                *reinterpret_cast<uint4*>(dst + 16 * k) =
                    make_uint4(spread4(o & 0xF), spread4((o >> 4) & 0xF),
                               spread4((o >> 8) & 0xF),
                               spread4((o >> 12) & 0xF));
              }
            }
          } else {
            for (int i = 0; i < C && x0 + i < ch.W; ++i)
              dst[i] = static_cast<uint8_t>((over >> i) & 1);
          }
        }
      }
      ++row;
      slot = slot + 1 == ring ? 0 : slot + 1;
      if (s + 1 < kCombRows) {
        b = bits_of(row);
        if (reads_post) p = *post_of(row);
      }
    }
    comb_barrier();
  }
  return count;
}

// The producer warps (thread pt of np): the bits of chunk c + 1 while the
// walkers take steps c * kCombRows on.
__device__ void comb_produce(const CombChain& ch, int pt, int np) {
  for (int c = 0; c < ch.nsteps; ++c) {
    if (c + 1 < ch.nchunks)
      comb_outlier_rows(ch.ft, ch.fb, ch.W, ch.vec8, 2 + (c + 1) * kCombRows,
                        min(kCombRows, ch.nrows - (c + 1) * kCombRows),
                        ch.bits + (c + 1) % ch.stages * kCombRows * ch.pitch,
                        ch.pitch, pt, np);
    comb_barrier();
  }
}

// Rows the wavefront spans at one step: from warp 0's lane 0 to the last
// warp's lane 31.
__host__ __device__ __forceinline__ int comb_span(int nw) {
  return (nw - 1) * (32 + kCombLag) + 32;
}

// Chunks in the bit ring: those the wavefront spans during a chunk of
// steps, and the one the producers fill meanwhile.
__host__ __device__ __forceinline__ int comb_stages(int nw) {
  return (comb_span(nw) + kCombRows - 1) / kCombRows + 2;
}

// score[n] = count of cells > 100 of chain n; kMask also writes mask[n]
// ([H, W] bytes 0/1, 0 outside rows 2 .. H-3).  Chain n weaves
// pool[top[n]] (even rows) and pool[bot[n]] (odd rows); with top == null
// it is the frame pool[n] itself.  Warps 0 .. nw-1 walk, the rest
// produce.  flags: 1 = 8-byte frame loads, 2 = 16-byte mask stores.
template <int C, bool kMask>
__global__ void __launch_bounds__(kCombThreads)
comb_chain_kernel(const uint8_t* __restrict__ pool,
                  const int32_t* __restrict__ top,
                  const int32_t* __restrict__ bot, int P, int H, int W,
                  int nw, int flags, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ score) {
  static_assert(C % 16 == 0 && C <= kCombMaxCols, "C: 16, 32 or 64");
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ long long s_post[kCombPosts * kCombSchedulers];
  __shared__ int s_count[kCombSchedulers];

  const int n = blockIdx.x;
  const int ti = top ? top[n] : n;
  const int bi = top ? bot[n] : n;
  if (ti < 0 || ti >= P || bi < 0 || bi >= P) {  // uniform: read nothing
    if (threadIdx.x == 0) score[n] = 0;
    return;
  }
  CombChain ch;
  const size_t plane = static_cast<size_t>(H) * W;
  ch.ft = pool + plane * ti;
  ch.fb = pool + plane * bi;
  ch.mk = kMask ? mask + plane * n : nullptr;
  ch.W = W;
  ch.nw = nw;
  ch.vec8 = flags & 1;
  ch.vec16 = flags & 2;
  const int nwords = (W + 31) >> 5;
  ch.pitch = nwords + 2;   // two zero words for the lanes' funnel shifts
  ch.stages = comb_stages(nw);
  ch.bits = reinterpret_cast<uint32_t*>(s_dyn);
  ch.post = s_post;
  ch.nrows = max(H - 4, 0);
  ch.nchunks = (ch.nrows + kCombRows - 1) / kCombRows;
  ch.nsteps = ch.nrows ? (ch.nrows + comb_span(nw) - 1 + kCombRows - 1) /
                             kCombRows
                       : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pt = threadIdx.x - 32 * nw;   // producer thread
  const int np = blockDim.x - 32 * nw;
  for (int i = threadIdx.x; i < kCombPosts * kCombSchedulers; i += blockDim.x)
    s_post[i] = -1;   // row -1: nothing posted
  if (warp >= nw) {
    for (int i = pt; i < ch.stages * kCombRows; i += np) {
      ch.bits[i * ch.pitch + nwords] = 0;
      ch.bits[i * ch.pitch + nwords + 1] = 0;
    }
    if (kMask) {   // the rows outside the band (every row when H < 5)
      for (int r = 0; r < H; ++r) {
        if (r == 2 && H - 2 > 2) r = H - 2;
        uint8_t* dst = ch.mk + static_cast<size_t>(r) * W;
        for (int x = pt; x < W; x += np) dst[x] = 0;
      }
    }
    if (ch.nchunks)
      comb_outlier_rows(ch.ft, ch.fb, W, ch.vec8, 2,
                        min(ch.nrows, kCombRows), ch.bits, ch.pitch, pt, np);
  }
  __syncthreads();

  if (warp < nw) {
    int count = comb_walk<C, kMask>(ch, warp, lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      count += __shfl_down_sync(kFull, count, o);
    if (lane == 0) s_count[warp] = count;
  } else {
    comb_produce(ch, pt, np);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < nw; ++w) total += s_count[w];
    score[n] = total;
  }
}

// The latency of the recurrence's dependent cell step, for the chain
// bound: one warp runs `steps` steps on registers, each one cell's
// select, add and clamp (comb_cells' loop body) on the cell before's
// result, and reports the clock cycles they took.  The outlier bits and
// carried values come from the thread, so nothing folds away.
__global__ void comb_row_cycles_kernel(long long* out, int steps) {
  const uint32_t b = 0xFFFFFFFFu >> (threadIdx.x & 1);
  const int carried = threadIdx.x + 1;
  int run = 0;
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += 32) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      run = (b >> k) & 1 ? run + carried : 0;
      run = min(run + 1, 1001);
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = run;
  }
}

// Bytes of dynamic shared memory: the bit ring.
size_t comb_smem(int W, int nw) {
  return static_cast<size_t>(comb_stages(nw)) * kCombRows *
         (((W + 31) >> 5) + 2) * sizeof(uint32_t);
}

// The walker warps for a width: about kCombLaneCols columns a lane, but
// no more warps than the SM has schedulers (a walker sharing one runs at
// half its speed) nor than the ring has room for.
int comb_walkers(int W) {
  int nw = (W + 32 * kCombLaneCols - 1) / (32 * kCombLaneCols);
  if (nw > kCombSchedulers) nw = kCombSchedulers;
  while (nw > 1 && comb_smem(W, nw) > kCombSmemLimit) --nw;
  return nw < 1 ? 1 : nw;
}

template <int C, bool kMask>
int comb_launch_cols(const uint8_t* pool, const int32_t* top,
                     const int32_t* bot, uint8_t* mask, int32_t* score,
                     int P, int N, int H, int W, int nw, int flags,
                     size_t smem, cudaStream_t stream) {
  const auto kernel = comb_chain_kernel<C, kMask>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<N, kCombThreads, smem, stream>>>(pool, top, bot, P, H, W, nw,
                                            flags, mask, score);
  return static_cast<int>(cudaGetLastError());
}

// Launch the chains with comb_walkers(W) walker warps.  C, the columns of
// a lane, is the first of 16, 32 and 64 that covers W (three widths keep
// the build short; lanes past W skip their cells).  Refuses a width whose
// C or ring does not fit.
template <bool kMask>
int comb_launch(const void* pool, const void* top, const void* bot,
                void* mask, void* score, int P, int N, int H, int W,
                void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const int nw = comb_walkers(W);
  const int per = (W + 32 * nw - 1) / (32 * nw);
  const int cols = per <= 16 ? 16 : per <= 32 ? 32 : 64;
  const size_t smem = comb_smem(W, nw);
  if (per > kCombMaxCols || smem > kCombSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if (W % 8 == 0 && reinterpret_cast<uintptr_t>(pool) % 8 == 0) flags |= 1;
  if (kMask && W % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0)
    flags |= 2;
  const auto* p = static_cast<const uint8_t*>(pool);
  const auto* t = static_cast<const int32_t*>(top);
  const auto* b = static_cast<const int32_t*>(bot);
  auto* m = static_cast<uint8_t*>(mask);
  auto* s = static_cast<int32_t*>(score);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (cols) {
#define GST_COMB_COLS(c)                                                    \
  case c:                                                                   \
    return comb_launch_cols<c, kMask>(p, t, b, m, s, P, N, H, W, nw, flags, \
                                      smem, st);
    GST_COMB_COLS(16)
    GST_COMB_COLS(32)
    GST_COMB_COLS(64)
#undef GST_COMB_COLS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int gst_fieldanalysis_metrics(const void* pool, const void* cur_idx,
                                         const void* prev_idx, const void* nf,
                                         void* out, int P, int B, int H,
                                         int W, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || H < 4 || H % 2 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // bands of about kMetricBandRows rows, even, as equal as they come
  int nbands = (H + kMetricBandRows / 2) / kMetricBandRows;
  if (nbands < 1) nbands = 1;
  int R = (H + nbands - 1) / nbands;
  R += R & 1;
  nbands = (H + R - 1) / R;
  // threads for one (8-column, band) item each, up to kMetricMaxThreads
  const long long items = static_cast<long long>((W + 7) / 8) * nbands;
  const long long per_block = (items + kMetricCluster - 1) / kMetricCluster;
  const int threads = static_cast<int>(
      per_block >= kMetricMaxThreads ? kMetricMaxThreads
      : per_block <= 64              ? 64
                                     : (per_block + 31) / 32 * 32);
  const uintptr_t base = reinterpret_cast<uintptr_t>(pool);
  const dim3 grid(kMetricCluster, B);
  const auto* q = static_cast<const uint8_t*>(pool);
  const auto* c = static_cast<const int32_t*>(cur_idx);
  const auto* v = static_cast<const int32_t*>(prev_idx);
  const auto* n = static_cast<const int32_t*>(nf);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (W % 8 == 0 && base % 8 == 0)
    fieldanalysis_metrics_kernel<true><<<grid, threads, 0, st>>>(
        q, c, v, n, o, P, B, H, W, R, nbands);
  else
    fieldanalysis_metrics_kernel<false><<<grid, threads, 0, st>>>(
        q, c, v, n, o, P, B, H, W, R, nbands);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_comb_score_pairs(const void* pool, const void* top_idx,
                                    const void* bot_idx, void* score, int P,
                                    int N, int H, int W, void* stream) {
  return comb_launch<false>(pool, top_idx, bot_idx, nullptr, score, P, N, H,
                            W, stream);
}

extern "C" int gst_comb_mask(const void* luma, void* mask, void* score, int N,
                             int H, int W, void* stream) {
  return comb_launch<true>(luma, nullptr, nullptr, mask, score, N, N, H, W,
                           stream);
}

extern "C" int gst_comb_row_cycles(void* out, int steps, void* stream) {
  comb_row_cycles_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
