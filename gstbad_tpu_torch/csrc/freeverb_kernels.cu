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
// serial: the comb input (x + DC)*gain does not depend on the output, a
// comb's tap is its own value of D samples before, and the allpasses have
// no lag-1 term at all, so within a sub-chunk of Ka <= A samples each
// sample's four stages run on their own lane.
//
// Design (one block of 128 threads; everything in shared memory).  A
// comb's tap at time t is the value it wrote at t - D, so each comb keeps
// a linear history of the values it writes, kHist (a power of two, longer
// than every ring plus two chunks) deep and mirrored kAhead past its end,
// instead of its ring: its lane writes at t & (kHist - 1) and reads at
// (t - D) & (kHist - 1) with no other position arithmetic.  The rings come
// in and go out in the JAX layout (index t mod D) at the ends of the
// launch.  Chunks of K samples (a multiple of kAhead); in iteration c,
//   - lanes 0-15 of warp 0 walk the combs over chunk c, reading their taps
//     one group of kAhead steps ahead of the writes (a read D >= 32 steps
//     back never meets them) and the comb inputs staged the iteration
//     before; the history rows sit on distinct banks, so the writes of the
//     16 lanes never conflict;
//   - warps 1-3 stage chunk c + 1's samples, sum chunk c - 1's taps (read
//     back from the histories, not yet overwritten) in comb order, and run
//     its allpasses and mix, Ka lanes a sub-chunk, one named barrier
//     between the phases and a sub-chunk.
// One block barrier a chunk.  Two earlier designs were slower on the
// card: a walk over the rings themselves (a wrap test a step, conflicting
// banks), and one over taps that the other warps staged from the rings
// and whose values they wrote back (the walk waited for them).  What holds
// this one above its chain is not measured (no stall counters); a step of
// the walk issues some eight instructions from its one warp.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;            // warp 0 walks, warps 1-3 the rest
constexpr int kApThreads = kThreads - 32;
constexpr int kMaxChunk = 256;
constexpr int kAhead = 16;               // comb steps per group
constexpr int kHist = 2048;              // comb history depth (a power of 2)
constexpr int kHistMask = kHist - 1;
// a history row, with its mirror; 2065 = 17 mod 32, so the 16 rows start
// on 16 distinct banks
constexpr int kHistRow = kHist + kAhead + 1;
constexpr int kStride = kMaxChunk + 1;   // sample rows, off the bank period
constexpr int kCombs = 16;               // 8 left, then 8 right
constexpr int kRings = 24;               // the combs, then 4 + 4 allpasses
constexpr int kAps = kRings - kCombs;
constexpr float kDC = 1e-8f;             // DC_OFFSET
// the floats of shared memory besides the allpass rings: the comb
// histories, the comb inputs and dry samples [3][2][kStride] each, the comb
// sums [2][kMaxChunk]
constexpr int kBufFloats =
    kCombs * kHistRow + 2 * 3 * 2 * kStride + 2 * kMaxChunk;

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

// the chunk length: a multiple of kAhead, at most kMaxChunk, with the
// longest comb plus two chunks and a group inside the history
__host__ __device__ inline int chunk_len(int rate) {
  int dmax = 0;
  for (int r = 0; r < kCombs; ++r) {
    const int d = ring_size(r, rate);
    dmax = d > dmax ? d : dmax;
  }
  const int k = (kHist - kAhead - dmax) / 2 / kAhead * kAhead;
  return k < kMaxChunk ? k : kMaxChunk;
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
  int n, mono, rate, cmax, amax;
};

__device__ inline const float* ring_src(const FvArgs& a, int r) {
  return r < kCombs ? a.comb_in[r >> 3] + (r & 7) * a.cmax
                    : a.ap_in[(r - kCombs) >> 2] + ((r - kCombs) & 3) * a.amax;
}

__device__ inline float* ring_dst(const FvArgs& a, int r) {
  return r < kCombs ? a.comb_out[r >> 3] + (r & 7) * a.cmax
                    : a.ap_out[(r - kCombs) >> 2] + ((r - kCombs) & 3) * a.amax;
}

// the comb inputs and dry samples of samples [base, base + k) into slot q
// of in1 and dry ([3][2][kStride]), by threads t = 0 .. kNt-1 (all the
// loads first)
template <int kNt>
__device__ inline void stage_samples(const FvArgs& a, float* in1, float* dry,
                                     int base, int k, float gain, int q,
                                     int t) {
  constexpr int kPer = (kMaxChunk + kNt - 1) / kNt;
  float* il = in1 + (q * 2) * kStride;
  float* dl = dry + (q * 2) * kStride;
  float xl[kPer], xr[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = t + j * kNt;
    if (s < k) {
      if (a.mono) {
        xl[j] = xr[j] = a.x[base + s];
      } else {
        xl[j] = a.x[2 * (base + s)];
        xr[j] = a.x[2 * (base + s) + 1];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = t + j * kNt;
    if (s < k) {
      if (a.mono) {
        il[s] = il[kStride + s] =
            __fmul_rn(__fadd_rn(__fmul_rn(2.f, xl[j]), kDC), gain);
      } else {
        il[s] = __fmul_rn(__fadd_rn(xl[j], kDC), gain);
        il[kStride + s] = __fmul_rn(__fadd_rn(xr[j], kDC), gain);
      }
      dl[s] = xl[j];
      dl[kStride + s] = xr[j];
    }
  }
}

__device__ inline void named_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kApThreads) : "memory");
}

__global__ void __launch_bounds__(kThreads) freeverb_scan_kernel(FvArgs a) {
  extern __shared__ float sm[];
  __shared__ int s_d[kRings], s_off[kAps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = *a.t_in;
  const int n = a.n, K = chunk_len(a.rate);
  if (tid < kRings) s_d[tid] = ring_size(tid, a.rate);
  __syncthreads();
  int ka = kApThreads;
  for (int r = kCombs; r < kRings; ++r) ka = min(ka, s_d[r]);
  const int Ka = ka;
  if (tid == 0) {
    int off = kCombs * kHistRow;
    for (int r = 0; r < kAps; ++r) {
      s_off[r] = off;
      off += s_d[kCombs + r];
    }
  }
  __syncthreads();
  float* const hist = sm;   // [16][kHistRow]
  float* const in1 = sm + s_off[kAps - 1] + s_d[kRings - 1];
  float* const dry_in = in1 + 3 * 2 * kStride;
  float* const sums = dry_in + 3 * 2 * kStride;
  // the comb rings into their histories: ring entry (t0 + j) mod D was
  // written at relative time j - D; the allpass rings as they are
  for (int i = 0; i < kCombs; ++i) {
    const float* src = ring_src(a, i);
    const int d = s_d[i], p0 = posmod(t0, d);
    for (int j = tid; j < d; j += kThreads) {
      int q = p0 + j;
      if (q >= d) q -= d;
      hist[i * kHistRow + ((j - d) & kHistMask)] = src[q];
    }
    for (int j = d + tid; j < a.cmax; j += kThreads)
      ring_dst(a, i)[j] = src[j];
  }
  for (int r = 0; r < kAps; ++r) {
    const float* src = ring_src(a, kCombs + r);
    float* dst = ring_dst(a, kCombs + r);
    const int d = s_d[kCombs + r];
    for (int j = tid; j < d; j += kThreads) sm[s_off[r] + j] = src[j];
    for (int j = d + tid; j < a.amax; j += kThreads) dst[j] = src[j];
  }
  __syncthreads();
  // the mirror of each history's first kAhead entries past its end
  for (int q = tid; q < kCombs * kAhead; q += kThreads)
    hist[(q / kAhead) * kHistRow + kHist + q % kAhead] =
        hist[(q / kAhead) * kHistRow + q % kAhead];
  const float fb = a.prm[0], d1 = a.prm[1], d2 = a.prm[2], w1 = a.prm[3],
              w2 = a.prm[4], dry = a.prm[5], gain = a.prm[6];
  const bool walker = warp == 0 && lane < kCombs;
  float st = walker ? a.store_in[lane >> 3][lane & 7] : 0.f;
  const int chunks = (n + K - 1) / K;
  if (chunks > 0)
    stage_samples<kThreads>(a, in1, dry_in, 0, min(K, n), gain, 0, tid);
  __syncthreads();

  for (int c = 0; c <= chunks; ++c) {
    const int base = c * K;
    const int k = c < chunks ? min(K, n - base) : 0;
    if (warp == 0) {
      // the comb walk of chunk c
      if (walker && k > 0) {
        float* h = hist + lane * kHistRow;
        const int d = s_d[lane];
        const float* in = in1 + ((c % 3) * 2 + (lane >> 3)) * kStride;
        float ct[kAhead], ci[kAhead];
        const float* rp = h + ((base - d) & kHistMask);
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          ct[j] = rp[j];
          ci[j] = in[j];
        }
        for (int s = 0; s < k; s += kAhead) {
          // the next group's taps and inputs (past k: not used)
          const int u = base + s;
          const float* np = h + ((u + kAhead - d) & kHistMask);
          float nt[kAhead], ni[kAhead];
#pragma unroll
          for (int j = 0; j < kAhead; ++j) {
            nt[j] = np[j];
            ni[j] = in[s + kAhead + j];
          }
          const int wq = u & kHistMask;   // a group never wraps
          float* wp = h + wq;
          float v[kAhead];
          if (s + kAhead <= k) {
#pragma unroll
            for (int j = 0; j < kAhead; ++j) {
              st = __fadd_rn(__fmul_rn(ct[j], d2), __fmul_rn(st, d1));
              v[j] = __fadd_rn(ci[j], __fmul_rn(st, fb));
              wp[j] = v[j];
            }
          } else {
#pragma unroll
            for (int j = 0; j < kAhead; ++j) {
              if (s + j < k) {
                st = __fadd_rn(__fmul_rn(ct[j], d2), __fmul_rn(st, d1));
                v[j] = __fadd_rn(ci[j], __fmul_rn(st, fb));
                wp[j] = v[j];
              }
            }
          }
          if (wq == 0) {   // the mirror
#pragma unroll
            for (int j = 0; j < kAhead; ++j)
              if (s + j < k) h[kHist + j] = v[j];
          }
#pragma unroll
          for (int j = 0; j < kAhead; ++j) {
            ct[j] = nt[j];
            ci[j] = ni[j];
          }
        }
      }
    } else {
      const int u0 = tid - 32;
      const int bp = (c - 1) * K, kp = c > 0 ? min(K, n - bp) : 0;
      const int k1 = c + 1 < chunks ? min(K, n - (c + 1) * K) : 0;
      if (k1 > 0)
        stage_samples<kApThreads>(a, in1, dry_in, (c + 1) * K, k1, gain,
                                  (c + 1) % 3, u0);
      if (kp > 0) {
        // chunk c - 1: its taps, read back from the histories, summed in
        // comb order; then its allpasses and mix
        for (int idx = u0; idx < 2 * kp; idx += kApThreads) {
          const int side = idx >= kp, s = idx - side * kp;
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = side * 8 + i;
            acc = __fadd_rn(
                acc, hist[r * kHistRow + ((bp + s - s_d[r]) & kHistMask)]);
          }
          sums[side * kMaxChunk + s] = acc;
        }
        named_barrier();
        const float* dr = dry_in + ((c + 2) % 3) * 2 * kStride;
        int pos[kAps];
        if (u0 < Ka) {
#pragma unroll
          for (int r = 0; r < kAps; ++r)
            pos[r] = posmod(t0 + bp + u0, s_d[kCombs + r]);
        }
        for (int u = 0; u < kp; u += Ka) {
          const int s = u + u0;
          if (u0 < Ka && s < kp) {
            // the eight allpass taps first: each stage reads and writes
            // its own ring, so the loads need not wait for the chain
            float b[kAps];
#pragma unroll
            for (int r = 0; r < kAps; ++r) b[r] = sm[s_off[r] + pos[r]];
            float out[2];
#pragma unroll
            for (int side = 0; side < 2; ++side) {
              float xv = sums[side * kMaxChunk + s];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = side * 4 + i;
                const float o = __fsub_rn(b[r], xv);
                sm[s_off[r] + pos[r]] = __fadd_rn(xv, __fmul_rn(b[r], 0.5f));
                xv = o;
              }
              out[side] = __fsub_rn(xv, kDC);
            }
            a.y[2 * (bp + s)] = __fadd_rn(
                __fadd_rn(__fmul_rn(out[0], w1), __fmul_rn(out[1], w2)),
                __fmul_rn(dr[s], dry));
            a.y[2 * (bp + s) + 1] = __fadd_rn(
                __fadd_rn(__fmul_rn(out[1], w1), __fmul_rn(out[0], w2)),
                __fmul_rn(dr[kStride + s], dry));
          }
          if (u0 < Ka) {
#pragma unroll
            for (int r = 0; r < kAps; ++r) {
              pos[r] += Ka;
              if (pos[r] >= s_d[kCombs + r]) pos[r] -= s_d[kCombs + r];
            }
          }
          // the next sub-chunk may read what this one wrote
          named_barrier();
        }
      }
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
      dst[q] = hist[i * kHistRow + ((n - d + j) & kHistMask)];
    }
  }
  for (int r = 0; r < kAps; ++r) {
    float* dst = ring_dst(a, kCombs + r);
    for (int j = tid; j < s_d[kCombs + r]; j += kThreads)
      dst[j] = sm[s_off[r] + j];
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
    int amax, void* stream) {
  // a walk reads its taps 2 * kAhead steps back at most before they are
  // written; a chunk is at least one group
  int rings = 0;
  for (int r = 0; r < kRings; ++r) {
    const int d = ring_size(r, rate);
    if (d < (r < kCombs ? 2 * kAhead : 1) || d > (r < kCombs ? cmax : amax))
      return static_cast<int>(cudaErrorInvalidValue);
    if (r >= kCombs) rings += d;
  }
  if (chunk_len(rate) < kAhead)
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
  freeverb_scan_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_freeverb_step_cycles(void* out, int steps, void* stream) {
  freeverb_step_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
