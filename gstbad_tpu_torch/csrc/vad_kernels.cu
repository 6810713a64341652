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
// 2^32 - 1, one thread per (block, bound), so its chain is one block long;
// the two threads of a block read the same samples, straight from global
// memory, 32 samples ahead of the chain.
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

// p after the n samples at x, from p (the bracket's walk)
__device__ __forceinline__ uint32_t walk(const int16_t* __restrict__ x,
                                         int n, uint32_t p) {
  int j = 0;
  for (; j + kAhead <= n; j += kAhead) {
    uint32_t a[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) a[k] = alpha_sq(__ldg(x + j + k));
#pragma unroll
    for (int k = 0; k < kAhead; ++k) p = vad_step(p, a[k]);
  }
  for (; j < n; ++j) p = vad_step(p, alpha_sq(__ldg(x + j)));
  return p;
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

// kSerial: one block; its thread 0 walks rows 0..nb-1 in order from *p0
// and writes each row's end power to out_a[r], reading the squares that
// warps 1-7 stage a chunk ahead.  Otherwise: thread 2r + h walks row r
// from 0 (h = 0, into out_a[r]) or 2^32 - 1 (h = 1, into out_b[r]).
template <bool kSerial>
__global__ void vad_power_kernel(const int16_t* __restrict__ x, int nb,
                                 int n, const long long* __restrict__ p0,
                                 long long* __restrict__ out_a,
                                 long long* __restrict__ out_b) {
  if (kSerial) {
    __shared__ uint32_t stage[2][kChunk];
    const long long total = static_cast<long long>(nb) * n;
    const int chunks = static_cast<int>((total + kChunk - 1) / kChunk);
    const bool walker = threadIdx.x == 0;
    const bool stager = threadIdx.x >= 32;
    uint32_t p = static_cast<uint32_t>(*p0);
    if (n == 0) {   // no samples: every block ends on p0
      for (int r = threadIdx.x; r < nb; r += kSerialThreads) out_a[r] = p;
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
            out_a[r++] = p;
            row_end += n;
          }
        }
      }
      __syncthreads();
    }
  } else {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= 2 * nb) return;
    const int r = t >> 1;
    const bool high = (t & 1) != 0;
    const uint32_t p = walk(x + static_cast<long long>(r) * n, n,
                            high ? 0xFFFFFFFFu : 0u);
    (high ? out_b : out_a)[r] = p;
  }
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

constexpr int kBracketThreads = 64;

}  // namespace

extern "C" int gst_vad_powers_serial(const void* x, const void* p0, void* out,
                                     int nb, int n, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  vad_power_kernel<true><<<1, kSerialThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), nb, n,
      static_cast<const long long*>(p0), static_cast<long long*>(out),
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_vad_powers_bracket(const void* x, void* lo, void* hi,
                                      int nb, int n, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (2 * nb + kBracketThreads - 1) / kBracketThreads;
  vad_power_kernel<false><<<blocks, kBracketThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), nb, n, nullptr,
      static_cast<long long*>(lo), static_cast<long long*>(hi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_vad_step_cycles(void* out, int steps, void* stream) {
  vad_step_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
