// Hand-written Hopper kernels of the removesilence VAD power recurrence
// (gstbad_tpu_torch/ops/audio.py).  Plain C entry points, loaded with ctypes
// by gstbad_tpu_torch/ops/_cuda.py; each launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so vad_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K8: the VAD's truncating power recurrence (vad_private.c:117)
//   p' = 2048*s + floor(63487*p / 2^16),  s = ((d*d) >> 14) & 0xFFFF
// over S16 samples d, and the power at the end of every block.
//
// Replaces gstbad_tpu/ops/audio.py:_vad_power_kernel (the serial mode)
// and the XLA scan _vad_powers_bracket (the bracket mode).  The TPU kernel
// carried p as two 16-bit limbs because Mosaic has no 64-bit integers;
// here p is one uint32: it stays below 2^32 (from 2^32 - 1 one step gives
// at most 4294899711), and since 63487 << 16 < 2^32,
//   floor(63487*p / 2^16) = umulhi(p, 63487 << 16),
// so a step is one multiply-high and one add, which nvcc emits as one
// IMAD.HI (its addend moved into a register pair): the dependency chain is
// one instruction per sample, about 9 cycles on an H100 (measured by
// vad_step_cycles_kernel below).
//
// Bound: the chain.  The serial mode walks all nb*n samples in order in
// one thread, so its time is the number of samples times the latency of
// one step; bytes (2 per sample) and operations are far below that.  So
// the walking thread must never wait for memory: seven other warps of its
// block square the samples into shared memory a 4096-sample chunk ahead
// (double-buffered), and the walk reads the squares from there, 32 steps'
// worth at a time.  The bracket mode runs each block from 0 and from
// 2^32 - 1, so its chain is one block long, n steps; it has a kernel of
// its own (vad_bracket_kernel, below).
// ---------------------------------------------------------------------------

constexpr uint32_t kBShifted = 63487u << 16;   // (0xFFFF - 0x0800) << 16
constexpr int kAhead = 32;                      // samples squared ahead

__device__ __forceinline__ uint32_t alpha_sq(int16_t d) {
  const int32_t v = d;
  return ((static_cast<uint32_t>(v * v) >> 14) & 0xFFFFu) << 11;
}

__device__ __forceinline__ uint32_t vad_step(uint32_t p, uint32_t a) {
  return __umulhi(p, kBShifted) + a;
}

constexpr int kSerialThreads = 256;   // warp 0 walks, warps 1-7 stage
constexpr int kChunk = 4096;          // samples per staged chunk

// squares of the samples [c*kChunk, (c+1)*kChunk) of x (total samples) into
// buf, by the threads of warps 1-7
__device__ __forceinline__ void stage_chunk(const int16_t* __restrict__ x,
                                            long long total, int c,
                                            uint32_t* buf) {
  const long long base = static_cast<long long>(c) * kChunk;
  for (int i = threadIdx.x - 32; i < kChunk; i += kSerialThreads - 32) {
    const long long g = base + i;
    buf[i] = g < total ? alpha_sq(__ldg(x + g)) : 0u;
  }
}

// One block; its thread 0 walks rows 0..nb-1 in order from *p0 and writes
// each row's end power to out[r], reading the squares that warps 1-7 stage
// a chunk ahead.
__global__ void vad_serial_kernel(const int16_t* __restrict__ x, int nb,
                                  int n, const long long* __restrict__ p0,
                                  long long* __restrict__ out) {
  __shared__ uint32_t stage[2][kChunk];
  const long long total = static_cast<long long>(nb) * n;
  const int chunks = static_cast<int>((total + kChunk - 1) / kChunk);
  const bool walker = threadIdx.x == 0;
  const bool stager = threadIdx.x >= 32;
  uint32_t p = static_cast<uint32_t>(*p0);
  if (n == 0) {   // no samples: every block ends on p0
    for (int r = threadIdx.x; r < nb; r += kSerialThreads) out[r] = p;
    return;
  }
  if (stager && chunks > 0) stage_chunk(x, total, 0, stage[0]);
  __syncthreads();
  long long row_end = n;   // global index just past row r
  int r = 0;
  for (int c = 0; c < chunks; ++c) {
    if (stager) {
      if (c + 1 < chunks) stage_chunk(x, total, c + 1, stage[(c + 1) & 1]);
    } else if (walker) {
      const uint32_t* a = stage[c & 1];
      const long long base = static_cast<long long>(c) * kChunk;
      const int len = static_cast<int>(
          total - base < kChunk ? total - base : kChunk);
      int j = 0;
      while (j < len) {
        const int stop = static_cast<int>(
            row_end - base < len ? row_end - base : len);
        // the squares into registers first, then the steps: loads
        // interleaved with the steps would put their latency on the chain
        for (; j + kAhead <= stop; j += kAhead) {
          uint32_t v[kAhead];
#pragma unroll
          for (int k = 0; k < kAhead; ++k) v[k] = a[j + k];
#pragma unroll
          for (int k = 0; k < kAhead; ++k) p = vad_step(p, v[k]);
        }
        for (; j < stop; ++j) p = vad_step(p, a[j]);
        if (base + j == row_end) {
          out[r++] = p;
          row_end += n;
        }
      }
    }
    __syncthreads();
  }
}


// ---------------------------------------------------------------------------
// The bracket mode: each row r of [nb, n] walked from 0 (into lo[r]) and
// from 2^32 - 1 (into hi[r]), both over the whole row.
//
// Replaces the XLA scan gstbad_tpu/ops/audio.py:_vad_powers_bracket.  Bound:
// the chain of one row, n dependent steps (the rows run side by side on
// their own SMs).  Design: one block a row.  All its threads square the
// row's first chunk of kBracketChunk samples into shared memory, reading
// 16 bytes a thread where the rows are 16-byte aligned (n % 8 == 0), 2
// otherwise; then lanes 0 and 1 of warp 0 walk it (the two walks in one
// instruction stream; the other lanes walk copies that are dropped), while
// warps 1-3 square the next chunk into the other buffer, one barrier a
// chunk.  A walker reads its next 32 squares from shared memory (eight
// 16-byte loads) before it steps the current 32, so no load latency sits
// on the chain.
// ---------------------------------------------------------------------------

constexpr int kBracketThreads = 128;   // warp 0 walks, warps 1-3 stage
constexpr int kBracketChunk = 2048;    // samples per staged chunk

// the squares of samples [c0, c0 + len) of row q into buf, by threads
// t = 0 .. nt-1 of the block; kVec: 8 samples a 16-byte load (c0 and len
// multiples of 8, q 16-byte aligned)
template <bool kVec>
__device__ __forceinline__ void stage_bracket(const int16_t* __restrict__ q,
                                              int c0, int len,
                                              uint32_t* __restrict__ buf,
                                              int t, int nt) {
  if (kVec) {
    const uint4* q4 = reinterpret_cast<const uint4*>(q + c0);
    uint4* b4 = reinterpret_cast<uint4*>(buf);
    for (int i = t; i < len / 8; i += nt) {
      const uint4 v = __ldg(q4 + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t a[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[2 * k] = alpha_sq(static_cast<int16_t>(w[k] & 0xFFFFu));
        a[2 * k + 1] = alpha_sq(static_cast<int16_t>(w[k] >> 16));
      }
      b4[2 * i] = make_uint4(a[0], a[1], a[2], a[3]);
      b4[2 * i + 1] = make_uint4(a[4], a[5], a[6], a[7]);
    }
  } else {
    for (int i = t; i < len; i += nt) buf[i] = alpha_sq(__ldg(q + c0 + i));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBracketThreads)
    vad_bracket_kernel(const int16_t* __restrict__ x, int n,
                       long long* __restrict__ lo,
                       long long* __restrict__ hi) {
  // kAhead squares of slack past each chunk: the walk loads its next batch
  // before it knows whether there is one
  __shared__ __align__(16) uint32_t stage[2][kBracketChunk + kAhead];
  const int r = blockIdx.x;
  const int16_t* q = x + static_cast<long long>(r) * n;
  const int chunks = (n + kBracketChunk - 1) / kBracketChunk;
  const int warp = threadIdx.x >> 5;
  uint32_t p = (threadIdx.x & 1) ? 0xFFFFFFFFu : 0u;
  if (chunks > 0)
    stage_bracket<kVec>(q, 0, min(n, kBracketChunk), stage[0], threadIdx.x,
                        kBracketThreads);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (warp != 0) {
      const int c1 = (c + 1) * kBracketChunk;
      if (c1 < n)
        stage_bracket<kVec>(q, c1, min(n - c1, kBracketChunk),
                            stage[(c + 1) & 1], threadIdx.x - 32,
                            kBracketThreads - 32);
    } else {
      const uint32_t* a = stage[c & 1];
      const int len = min(n - c * kBracketChunk, kBracketChunk);
      const uint4* a4 = reinterpret_cast<const uint4*>(a);
      uint4 cur[kAhead / 4];
#pragma unroll
      for (int k = 0; k < kAhead / 4; ++k) cur[k] = a4[k];
      int j = 0;
      for (; j + kAhead <= len; j += kAhead) {
        uint4 nxt[kAhead / 4];
#pragma unroll
        for (int k = 0; k < kAhead / 4; ++k)
          nxt[k] = a4[(j + kAhead) / 4 + k];
#pragma unroll
        for (int k = 0; k < kAhead / 4; ++k) {
          p = vad_step(p, cur[k].x);
          p = vad_step(p, cur[k].y);
          p = vad_step(p, cur[k].z);
          p = vad_step(p, cur[k].w);
        }
#pragma unroll
        for (int k = 0; k < kAhead / 4; ++k) cur[k] = nxt[k];
      }
      for (; j < len; ++j) p = vad_step(p, a[j]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 2) (threadIdx.x ? hi : lo)[r] = p;
}

// The latency of the chain: one thread runs `steps` dependent steps (a
// multiple of kAhead) in the serial walk's form on registers alone (the
// addends held in registers, kAhead steps per loop trip) and reports the
// clock cycles they took.  Used for K8's bound.  The values depend on the
// thread, so the steps run on the vector datapath, as in the walk.
__global__ void vad_step_cycles_kernel(long long* out, int steps) {
  const uint32_t seed = static_cast<uint32_t>(steps) ^ threadIdx.x;
  uint32_t v[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) v[k] = ((seed + k) & 0xFFFFu) << 11;
  uint32_t p = 0x9E3779B9u ^ seed;
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) p = vad_step(p, v[k]);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = p;
}

}  // namespace

extern "C" int gst_vad_powers_serial(const void* x, const void* p0, void* out,
                                     int nb, int n, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  vad_serial_kernel<<<1, kSerialThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), nb, n,
      static_cast<const long long*>(p0), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_vad_powers_bracket(const void* x, void* lo, void* hi,
                                      int nb, int n, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  const auto* q = static_cast<const int16_t*>(x);
  auto* l = static_cast<long long*>(lo);
  auto* h = static_cast<long long*>(hi);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    vad_bracket_kernel<true><<<nb, kBracketThreads, 0, st>>>(q, n, l, h);
  else
    vad_bracket_kernel<false><<<nb, kBracketThreads, 0, st>>>(q, n, l, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_vad_step_cycles(void* out, int steps, void* stream) {
  vad_step_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
