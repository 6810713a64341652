// Hand-written Hopper kernel of freeverb's per-sample walk, the form the
// reverb takes below 32 kHz (gstbad_tpu_torch/ops/audio.py freeverb_scan).
// Plain C entry points, loaded with ctypes by gstbad_tpu_torch/ops/_cuda.py;
// each launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so freeverb_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// freeverb's serial loop (gstfreeverb.c:288-330): per sample, per side, 8
// parallel combs
//   tmp = buf[t mod D]; store = tmp*damp2 + store*damp1;
//   buf[t mod D] = in + store*feedback
// whose taps are summed in comb order, then 4 series allpasses
//   bufout = buf[t mod A]; out = bufout - x; buf[t mod A] = x + bufout*0.5
// then the DC offset and the wet/dry mix.
//
// Not a TPU kernel: it replaces the XLA lax.scan
// gstbad_tpu/ops/audio.py:_freeverb_process_scan.  It computes what that
// scan computes, in the C's operation order (every product and sum
// rounded on its own: __fmul_rn / __fadd_rn, no contraction into FMA).
//
// Bound: the dependency chain.  A comb's filterstore is a lag-1 recurrence
// (one multiply and one add a sample), so each comb walks its N samples in
// order; the 16 combs (8 a side) walk side by side.  Nothing else is
// serial: a comb's tap at time t is its own value of D samples before, so
// tmp*damp2 is known D samples ahead; the comb input (x + DC)*gain does not
// depend on the output; and the allpasses have no lag-1 term at all, so
// within a sub-chunk of Ka <= A samples each sample's four stages run on
// their own lane.
//
// Design (one block of 256 threads; everything in shared memory).  The
// walk runs in chunks of K samples, K at most half the shortest comb
// (ops/audio.freeverb_chunk), so that every tap of chunk c + 1 was
// written by chunk c - 1 or earlier.  Each comb keeps a linear history of
// the values it writes, kHist (a power of two, longer than every ring and
// a chunk) deep; the rings come in and go out in the JAX layout (index t
// mod D) at the ends of the launch.  In iteration c,
//   - lanes 0-15 of warp 0 (one a comb) walk chunk c and issue only the
//     chain: st = a[t] + st*damp1, where a[t] = tap*damp2 comes from
//     shared memory in 16-byte loads a group of 16 steps ahead and st goes
//     back in 16-byte stores, two groups a trip with registers of their
//     own;
//   - warps 5-7 (group A) stage chunk c + 3's samples (cp.async), write
//     chunk c - 1 into the histories (in + st*feedback, from the walk's
//     stores) and then read chunk c + 1's taps: a for the walk, and their
//     sums in comb order; each thread issues all the loads of three
//     samples before their arithmetic;
//   - warps 1-4 (group B, two a side) run chunk c's allpasses from the
//     sums group A read the iteration before, at most the side's shortest
//     allpass of samples a sub-chunk (one named barrier each), then its
//     wet/dry mix.
// One block barrier a chunk.  The earlier design kept the whole comb step
// in the walker (the tap and input loads, ct*damp2, the feedback product
// and the history store: some eight instructions a step from its one
// warp) and ran the taps, allpasses and mix on three warps one after
// another: 1.82 ms at [141120, 2] and 22.05 kHz on an H100 80GB HBM3 at
// 700 W, about 25.6 cycles a sample against the 8.2-cycle chain; one-off
// copies of it with no walk at all, or with the walker's loads taken out,
// ran only a little faster, so both sides held it.  This one takes about
// 1.14 ms there, 16 cycles a sample, about what one-off copies of the walk
// alone took: its shared loads and stores queue behind the other warps'
// (PERF.md section 6).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
// warp 0 walks; warps 1-4 (group B) run the allpasses and the mix, two
// warps a side; warps 5-7 (group A) stage the samples, write the
// histories and read the taps
constexpr int kB = 128, kA = 96;
constexpr int kBSide = kB / 2;
constexpr int kMaxChunk = 256;
constexpr int kGroup = 16;               // walk steps a loop trip
constexpr int kHist = 2048;              // comb history depth (a power of 2)
constexpr int kHistMask = kHist - 1;
// a comb's row of a (or of the walk's filterstores) for one chunk, with
// room for the walk's loads past its last group; 276 / 4 = 69 is odd, so
// the 16-byte accesses of 8 lanes fall on 8 distinct bank groups
constexpr int kRowA = kMaxChunk + kGroup + 4;
constexpr int kXSlot = 2 * kMaxChunk;    // one chunk's samples
constexpr int kXSlots = 5;               // chunks c - 2 .. c + 3 but c - 2
constexpr int kUnroll = (kMaxChunk + kA - 1) / kA;
constexpr int kCombs = 16;               // 8 left, then 8 right
constexpr int kRings = 24;               // the combs, then 4 + 4 allpasses
constexpr int kAps = kRings - kCombs;
constexpr float kDC = 1e-8f;             // DC_OFFSET
// the floats of shared memory besides the allpass rings: the histories,
// a and the filterstores [2][16][kRowA] each, the samples, the tap sums
// [2][2][kMaxChunk] and the allpass outputs [2][kMaxChunk]
constexpr int kBufFloats = kCombs * kHist + 2 * 2 * kCombs * kRowA +
                           kXSlots * kXSlot + 3 * 2 * kMaxChunk;

__host__ __device__ inline int ring_base(int r) {
  // comb and allpass tunings at 44.1 kHz (gstfreeverb.c), right = left + 23
  const int comb[8] = {1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617};
  const int ap[4] = {556, 441, 341, 225};
  if (r < 8) return comb[r];
  if (r < 16) return comb[r - 8] + 23;
  if (r < 20) return ap[r - 16];
  return ap[r - 20] + 23;
}

// freeverb_sizes: int32(tuning * (rate / 44100.0)) in double, as numpy
__host__ __device__ inline int ring_size(int r, int rate) {
  return static_cast<int>(ring_base(r) * (rate / 44100.0));
}

// jnp.remainder(t, d) for d > 0
__device__ inline int posmod(long long t, int d) {
  const long long r = t % d;
  return static_cast<int>(r < 0 ? r + d : r);
}

struct FvArgs {
  const float* x;           // [n] mono or [n, 2]
  float* y;                 // [n, 2]
  const float* comb_in[2];  // left, right: [8, cmax]
  const float* ap_in[2];    // [4, amax]
  const float* store_in[2]; // [8]
  const int* t_in;
  const float* prm;         // feedback, damp1, damp2, wet1, wet2, dry, gain
  float* comb_out[2];
  float* ap_out[2];
  float* store_out[2];
  int* t_out;
  int n, mono, rate, cmax, amax, chunk;
};

__device__ inline const float* ring_src(const FvArgs& a, int r) {
  return r < kCombs ? a.comb_in[r >> 3] + (r & 7) * a.cmax
                    : a.ap_in[(r - kCombs) >> 2] + ((r - kCombs) & 3) * a.amax;
}

__device__ inline float* ring_dst(const FvArgs& a, int r) {
  return r < kCombs ? a.comb_out[r >> 3] + (r & 7) * a.cmax
                    : a.ap_out[(r - kCombs) >> 2] + ((r - kCombs) & 3) * a.amax;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// named barriers: 1 group A, 2 and 3 group B's sides, 4 group B
__device__ __forceinline__ void bar_named(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A chunk's place: its first sample and its length.
struct Chunk {
  int base, k;
};

__device__ __forceinline__ Chunk chunk_at(int c, int K, int n) {
  return Chunk{c * K, min(K, n - c * K)};
}

// group A (u = 0 .. 95): chunk c's samples into slot c % 5, one cp.async
// group (empty past the last chunk)
__device__ __forceinline__ void stage_chunk(const float* x, int mono, int n,
                                            int K, int chunks, float* xbuf,
                                            int c, int u) {
  if (c < chunks) {
    const Chunk ch = chunk_at(c, K, n);
    const int m = (mono ? 1 : 2) * ch.k;
    const float* src = x + (mono ? 1 : 2) * static_cast<size_t>(ch.base);
    float* dst = xbuf + (c % kXSlots) * kXSlot;
    for (int i = u; i < m; i += kA) cp_async4(dst + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float sample_of(const float* xs, int mono,
                                           int side, int s) {
  return mono ? xs[s] : xs[2 * s + side];
}

// lanes 0-15 of warp 0: comb `lane`'s chain over chunk c, returning the
// filterstore.  Two groups of 16 steps a trip, each with registers of its
// own, so that a group's stores never hold up the next group's chain; a
// group's 16-byte loads are issued a group ahead.
__device__ __forceinline__ void load_group(float (&v)[kGroup],
                                           const float* p) {
#pragma unroll
  for (int m = 0; m < kGroup / 4; ++m) {
    const float4 q = *reinterpret_cast<const float4*>(p + 4 * m);
    v[4 * m] = q.x;
    v[4 * m + 1] = q.y;
    v[4 * m + 2] = q.z;
    v[4 * m + 3] = q.w;
  }
}

__device__ __forceinline__ void store_group(float* p,
                                            const float (&v)[kGroup]) {
#pragma unroll
  for (int m = 0; m < kGroup / 4; ++m)
    *reinterpret_cast<float4*>(p + 4 * m) =
        make_float4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
}

// st through the group's a values (the first `k` of them), each replaced
// by the filterstore after it
__device__ __forceinline__ float chain_group(float (&v)[kGroup], int k,
                                             float st, float d1) {
  if (k >= kGroup) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      st = __fadd_rn(v[j], __fmul_rn(st, d1));
      v[j] = st;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < k) st = __fadd_rn(v[j], __fmul_rn(st, d1));
      v[j] = st;
    }
  }
  return st;
}

__device__ __forceinline__ float walk_chunk(const float* ar, float* sr,
                                            int k, float st, float d1) {
  float va[kGroup], vb[kGroup];
  load_group(va, ar);
  for (int s = 0; s < k; s += 2 * kGroup) {
    load_group(vb, ar + s + kGroup);   // past k: not used
    st = chain_group(va, k - s, st, d1);
    store_group(sr + s, va);
    load_group(va, ar + s + 2 * kGroup);
    if (s + kGroup < k) {
      st = chain_group(vb, k - s - kGroup, st, d1);
      store_group(sr + s + kGroup, vb);
    }
  }
  return st;
}

// group A: chunk c into the histories, in + st*feedback from the walk's
// filterstores.  A thread's kUnroll samples of a side at a time, all their
// loads first, so that they overlap.
__device__ __forceinline__ void commit_chunk(float* hist, const float* sr,
                                             const float* xs, Chunk ch,
                                             int mono, float gain, float fb,
                                             int u) {
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    for (int s0 = u; s0 < ch.k; s0 += kUnroll * kA) {
      float v[kUnroll][8], xv[kUnroll];
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int s = s0 + m * kA;
        if (s < ch.k) {
          xv[m] = sample_of(xs, mono, side, s);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[m][i] = sr[(side * 8 + i) * kRowA + s];
        }
      }
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int s = s0 + m * kA;
        if (s < ch.k) {
          const float in1 =
              mono ? __fmul_rn(__fadd_rn(__fmul_rn(2.f, xv[m]), kDC), gain)
                   : __fmul_rn(__fadd_rn(xv[m], kDC), gain);
          const int q = (ch.base + s) & kHistMask;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            hist[(side * 8 + i) * kHist + q] =
                __fadd_rn(in1, __fmul_rn(v[m][i], fb));
        }
      }
    }
  }
}

// group A: chunk c's taps: a = tap*damp2 for the walk, and their sums in
// comb order for group B; loads first, as in commit_chunk
__device__ __forceinline__ void taps_chunk(const float* hist, float* ar,
                                           float* sums, const int* s_d,
                                           Chunk ch, float d2, int u) {
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    int lag[8];   // a tap's time less the sample's: base - D
#pragma unroll
    for (int i = 0; i < 8; ++i) lag[i] = ch.base - s_d[side * 8 + i];
    for (int s0 = u; s0 < ch.k; s0 += kUnroll * kA) {
      float tap[kUnroll][8];
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int s = s0 + m * kA;
        if (s < ch.k) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            tap[m][i] = hist[(side * 8 + i) * kHist +
                             ((lag[i] + s) & kHistMask)];
        }
      }
#pragma unroll
      for (int m = 0; m < kUnroll; ++m) {
        const int s = s0 + m * kA;
        if (s < ch.k) {
          float acc = tap[m][0];
#pragma unroll
          for (int i = 1; i < 8; ++i) acc = __fadd_rn(acc, tap[m][i]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            ar[(side * 8 + i) * kRowA + s] = __fmul_rn(tap[m][i], d2);
          sums[side * kMaxChunk + s] = acc;
        }
      }
    }
  }
}

// group B, lane u = 0 .. 63 of its side's two warps: the side's four
// allpasses over chunk c from its tap sums, `lanes` samples (at most the
// side's shortest allpass) a sub-chunk, the side's warps synchronised
// between sub-chunks; the side's output less the DC offset into apo.
// p0[r] = t0 mod A_r.
__device__ __forceinline__ void allpass_side(float* aps, const int* s_d,
                                             const int* s_off,
                                             const float* sums, float* apo,
                                             Chunk ch, const int* p0,
                                             int side, int lanes, int u) {
  int pos[4], len[4], off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = side * 4 + i;
    len[i] = s_d[kCombs + r];
    off[i] = s_off[r];
    pos[i] = static_cast<int>(static_cast<unsigned>(p0[r] + ch.base + u) %
                              static_cast<unsigned>(len[i]));
  }
  for (int s0 = 0; s0 < ch.k; s0 += lanes) {
    const int s = s0 + u;
    if (u < lanes && s < ch.k) {
      // the four taps first: each stage reads and writes its own ring, so
      // the loads need not wait for the chain
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = aps[off[i] + pos[i]];
      float xv = sums[side * kMaxChunk + s];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float o = __fsub_rn(b[i], xv);
        aps[off[i] + pos[i]] = __fadd_rn(xv, __fmul_rn(b[i], 0.5f));
        xv = o;
      }
      apo[side * kMaxChunk + s] = __fsub_rn(xv, kDC);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pos[i] += lanes;
      if (pos[i] >= len[i]) pos[i] -= len[i];
    }
    // the next sub-chunk may read what this one wrote
    bar_named(2 + side, kBSide);
  }
}

struct Mix {
  float w1, w2, dry;
};

// group B (u = 0 .. 127): chunk c's wet/dry mix from the allpass outputs
__device__ __forceinline__ void mix_chunk(const float* apo, const float* xs,
                                          float* y, Chunk ch, int mono,
                                          Mix mx, int u) {
  for (int s = u; s < ch.k; s += kB) {
    const float l = apo[s], r = apo[kMaxChunk + s];
    y[2 * (ch.base + s)] =
        __fadd_rn(__fadd_rn(__fmul_rn(l, mx.w1), __fmul_rn(r, mx.w2)),
                  __fmul_rn(sample_of(xs, mono, 0, s), mx.dry));
    y[2 * (ch.base + s) + 1] =
        __fadd_rn(__fadd_rn(__fmul_rn(r, mx.w1), __fmul_rn(l, mx.w2)),
                  __fmul_rn(sample_of(xs, mono, 1, s), mx.dry));
  }
}

__global__ void __launch_bounds__(kThreads) freeverb_scan_kernel(FvArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_d[kRings], s_off[kAps], s_p0[kAps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = *a.t_in;
  const int n = a.n, K = a.chunk, mono = a.mono;
  if (tid < kRings) s_d[tid] = ring_size(tid, a.rate);
  __syncthreads();
  if (tid < kAps) s_p0[tid] = posmod(t0, s_d[kCombs + tid]);
  float* const hist = sm;                               // [16][kHist]
  float* const abuf = hist + kCombs * kHist;            // [2][16][kRowA]
  float* const sbuf = abuf + 2 * kCombs * kRowA;        // [2][16][kRowA]
  float* const xbuf = sbuf + 2 * kCombs * kRowA;        // [5][kXSlot]
  float* const sums = xbuf + kXSlots * kXSlot;          // [2][2][kMaxChunk]
  float* const apo = sums + 4 * kMaxChunk;              // [2][kMaxChunk]
  float* const aps = apo + 2 * kMaxChunk;               // the allpass rings
  if (tid == 0) {
    int off = 0;
    for (int r = 0; r < kAps; ++r) {
      s_off[r] = off;
      off += s_d[kCombs + r];
    }
  }
  // the comb rings into their histories: ring entry (t0 + j) mod D was
  // written at relative time j - D
  for (int i = 0; i < kCombs; ++i) {
    const float* src = ring_src(a, i);
    const int d = s_d[i], p0 = posmod(t0, d);
    for (int j = tid; j < d; j += kThreads) {
      int q = p0 + j;
      if (q >= d) q -= d;
      hist[i * kHist + ((j - d) & kHistMask)] = src[q];
    }
    for (int j = d + tid; j < a.cmax; j += kThreads)
      ring_dst(a, i)[j] = src[j];
  }
  __syncthreads();   // s_off, s_p0
  for (int r = 0; r < kAps; ++r) {
    const float* src = ring_src(a, kCombs + r);
    float* dst = ring_dst(a, kCombs + r);
    const int d = s_d[kCombs + r];
    for (int j = tid; j < d; j += kThreads) aps[s_off[r] + j] = src[j];
    for (int j = d + tid; j < a.amax; j += kThreads) dst[j] = src[j];
  }
  __syncthreads();
  const float fb = a.prm[0], d1 = a.prm[1], d2 = a.prm[2], gain = a.prm[6];
  const Mix mx{a.prm[3], a.prm[4], a.prm[5]};
  const bool walker = warp == 0 && lane < kCombs;
  float st = walker ? a.store_in[lane >> 3][lane & 7] : 0.f;
  const int chunks = (n + K - 1) / K;
  const float* const x = a.x;
  float* const y = a.y;
  const bool in_b = warp >= 1 && warp <= kB / 32;
  const int ub = tid - 32, ua = tid - 32 - kB;   // a thread's index in B, A
  const int side = ub / kBSide;                  // group B's side
  // a side's sub-chunk: at most its shortest allpass
  int lanes = kBSide;
  if (in_b)
    for (int i = 0; i < 4; ++i) lanes = min(lanes, s_d[kCombs + side * 4 + i]);

  if (warp > kB / 32) {   // group A: chunk 0's taps
    for (int c = 0; c < 3; ++c) stage_chunk(x, mono, n, K, chunks, xbuf, c, ua);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    bar_named(1, kA);
    if (chunks > 0)
      taps_chunk(hist, abuf, sums, s_d, chunk_at(0, K, n), d2, ua);
  }
  __syncthreads();
  // iteration c: the walk of chunk c; group A writes chunk c - 1 into the
  // histories and reads chunk c + 1's taps (chunk c - 1's values or older:
  // 2K <= D); group B runs chunk c's allpasses and mix from the sums group
  // A read the iteration before
  for (int c = 0; c <= chunks; ++c) {
    if (warp == 0) {
      if (walker && c < chunks)
        st = walk_chunk(abuf + (c & 1) * kCombs * kRowA + lane * kRowA,
                        sbuf + (c & 1) * kCombs * kRowA + lane * kRowA,
                        chunk_at(c, K, n).k, st, d1);
    } else if (in_b) {
      if (c < chunks) {
        const Chunk ch = chunk_at(c, K, n);
        allpass_side(aps, s_d, s_off, sums + (c & 1) * 2 * kMaxChunk, apo, ch,
                     s_p0, side, lanes, ub - side * kBSide);
        bar_named(4, kB);
        mix_chunk(apo, xbuf + (c % kXSlots) * kXSlot, y, ch, mono, mx, ub);
      }
    } else {
      stage_chunk(x, mono, n, K, chunks, xbuf, c + 3, ua);
      if (c > 0)
        commit_chunk(hist, sbuf + ((c - 1) & 1) * kCombs * kRowA,
                     xbuf + ((c - 1) % kXSlots) * kXSlot,
                     chunk_at(c - 1, K, n), mono, gain, fb, ua);
      bar_named(1, kA);
      if (c + 1 < chunks)
        taps_chunk(hist, abuf + ((c + 1) & 1) * kCombs * kRowA,
                   sums + ((c + 1) & 1) * 2 * kMaxChunk, s_d,
                   chunk_at(c + 1, K, n), d2, ua);
      // chunk c + 2's samples are in; c + 3's may still be on their way
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the histories back into rings: ring entry (t0 + n + j) mod D holds the
  // value of relative time n - D + j
  for (int i = 0; i < kCombs; ++i) {
    float* dst = ring_dst(a, i);
    const int d = s_d[i], p = posmod(t0 + n, d);
    for (int j = tid; j < d; j += kThreads) {
      int q = p + j;
      if (q >= d) q -= d;
      dst[q] = hist[i * kHist + ((n - d + j) & kHistMask)];
    }
  }
  for (int r = 0; r < kAps; ++r) {
    float* dst = ring_dst(a, kCombs + r);
    for (int j = tid; j < s_d[kCombs + r]; j += kThreads)
      dst[j] = aps[s_off[r] + j];
  }
  if (walker) a.store_out[lane >> 3][lane & 7] = st;
  if (tid == 0)
    *a.t_out = static_cast<int>(static_cast<unsigned>(t0) +
                                static_cast<unsigned>(n));
}

// The latency of the chain: one thread runs `steps` dependent comb steps
// (filterstore = tap*damp2 + filterstore*damp1, the walk's form, taps in
// registers, 32 steps a loop trip) and reports the clock cycles they took.
// Used for freeverb_scan's bound.
__global__ void freeverb_step_cycles_kernel(long long* out, int steps) {
  const float seed = 1.f + 1e-3f * static_cast<float>(threadIdx.x + steps);
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = seed + 0.01f * k;
  const float d1 = 0.2f * seed, d2 = 0.8f;
  float st = seed;
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += 32) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      st = __fadd_rn(__fmul_rn(v[k], d2), __fmul_rn(st, d1));
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = __float_as_int(st);
}

}  // namespace

extern "C" int gst_freeverb_scan(
    const void* x, void* y, const void* comb_l, const void* comb_r,
    const void* ap_l, const void* ap_r, const void* store_l,
    const void* store_r, const void* t, const void* prm, void* comb_l_out,
    void* comb_r_out, void* ap_l_out, void* ap_r_out, void* store_l_out,
    void* store_r_out, void* t_out, int n, int mono, int rate, int cmax,
    int amax, int chunk, void* stream) {
  // every ring at least a sample and within the state; a chunk's taps
  // written a chunk before it (2 * chunk <= the shortest comb), and the
  // longest comb and a chunk inside the history
  int rings = 0, dmin = kHist, dmax = 0;
  for (int r = 0; r < kRings; ++r) {
    const int d = ring_size(r, rate);
    if (d < 1 || d > (r < kCombs ? cmax : amax))
      return static_cast<int>(cudaErrorInvalidValue);
    if (r < kCombs) {
      dmin = d < dmin ? d : dmin;
      dmax = d > dmax ? d : dmax;
    } else {
      rings += d;
    }
  }
  if (n < 0 || chunk < 1 || chunk > kMaxChunk || 2 * chunk > dmin ||
      dmax + chunk > kHist)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (rings + kBufFloats);
  cudaError_t err = cudaFuncSetAttribute(
      freeverb_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  FvArgs a;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.comb_in[0] = static_cast<const float*>(comb_l);
  a.comb_in[1] = static_cast<const float*>(comb_r);
  a.ap_in[0] = static_cast<const float*>(ap_l);
  a.ap_in[1] = static_cast<const float*>(ap_r);
  a.store_in[0] = static_cast<const float*>(store_l);
  a.store_in[1] = static_cast<const float*>(store_r);
  a.t_in = static_cast<const int*>(t);
  a.prm = static_cast<const float*>(prm);
  a.comb_out[0] = static_cast<float*>(comb_l_out);
  a.comb_out[1] = static_cast<float*>(comb_r_out);
  a.ap_out[0] = static_cast<float*>(ap_l_out);
  a.ap_out[1] = static_cast<float*>(ap_r_out);
  a.store_out[0] = static_cast<float*>(store_l_out);
  a.store_out[1] = static_cast<float*>(store_r_out);
  a.t_out = static_cast<int*>(t_out);
  a.n = n;
  a.mono = mono;
  a.rate = rate;
  a.cmax = cmax;
  a.amax = amax;
  a.chunk = chunk;
  freeverb_scan_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_freeverb_step_cycles(void* out, int steps, void* stream) {
  freeverb_step_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
