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

#include <type_traits>

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
// Bound: the INT32 pipe at the main path's shape.  The least is 29/4
// instructions a pixel of each frame, with bytes packed four and 16-bit
// values two to an instruction (chip_smoke.py lists them: the ssd on
// bytes, the three 5-tap sums on even rows in 16-bit lanes): 0.051 ms for
// config 5's 128 frames on an H100 (132 SMs at 1980 MHz), above one read
// of every distinct frame (y and p overlap: p is mostly the frame before
// y), 0.92 MB per 1280x720 frame, 0.036 ms at 3.35 TB/s.  The TPU
// kernel's 4-pixel words are what such packing would take up; this kernel
// takes a pixel a thread.  Design: the frames are read from the pool
// by index, so no [B, H, W] gather of the previous frames is built.  Grid
// (column block, 32-row band, frame); each thread owns one column of a band
// and slides a five-row register window of y and p down it, so each byte
// is loaded once per band plus a 2-row halo on each side.  The sums are
// reduced per block with warp shuffles and added to the frame's five int64
// totals with one atomicAdd each.  Integer sums make the result exact in
// any order.  The TPU kernel's [8, W/4] accumulators are not carried
// over.
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
