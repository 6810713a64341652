// netsim's token bucket and drop-packets counter (gstbad_tpu_torch/ops/
// netsim.py netsim_bucket; gstnetsim.c:404-421 and :476-501) as one walk
// over a window's frames.  It replaces the JAX package's lax.scan
// (gstbad_tpu/elements/observability.py:223-251), not a TPU kernel; its
// plain version in ops/netsim.py holds it bit for bit.  The carry (the
// bucket's tokens, the meter's previous time and the counter) is serial, so
// one thread walks the frames in order; what bounds it is that chain
// (gst_netsim_step_cycles measures a step).  All arithmetic is int64 and
// wraps as XLA's does; divisions floor, as jnp's do.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

// floor(a / b) for b > 0
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Bucket {
  long long bucket, prev_time, dropn;
};

// One frame through the bucket and the counter (the JAX scan's step):
// returns whether the frame is kept.
__device__ __forceinline__ bool bucket_step(Bucket& c, long long pts,
                                            bool valid, long long bits,
                                            long long kbps, long long mbs) {
  const long long kNs = 1000000000LL;
  const bool first = c.prev_time < 0;
  const long long elapsed =
      first ? 0 : max(wrap_sub(pts, c.prev_time), 0LL);
  const bool unlimited_rate = kbps == -1;
  const long long cap = wrap_mul(mbs, 1000);
  const long long tokens =
      unlimited_rate ? wrap_sub(cap, c.bucket)
                     : floor_div(wrap_mul(wrap_mul(elapsed, kbps), 1000), kNs);
  const long long token_time =
      (unlimited_rate || kbps <= 0)
          ? 0
          : floor_div(wrap_mul(tokens, kNs), max(wrap_mul(kbps, 1000), 1LL));
  long long new_prev = first ? pts : wrap_add(c.prev_time, token_time);
  long long nb = min(wrap_add(c.bucket, tokens), cap);
  if (mbs == -1) nb = c.bucket;  // the bucket is bypassed
  const bool bucket_ok = mbs == -1 || bits <= nb;
  if (bucket_ok && mbs != -1 && valid) nb = wrap_sub(nb, bits);
  const bool counter_drop = valid && bucket_ok && c.dropn > 0;
  if (counter_drop) c.dropn -= 1;
  // only frames that reach the token code advance the meter
  if (!(valid && mbs != -1)) new_prev = c.prev_time;
  c.prev_time = new_prev;
  if (valid) c.bucket = nb;
  return valid && bucket_ok && !counter_drop;
}

constexpr int kThreads = 32;

// One thread walks the window's n frames in order.
__global__ void netsim_bucket_kernel(const long long* pts, const bool* valid,
                                     const int* kbps, const int* mbs,
                                     const long long* carry, bool* keep,
                                     long long* carry_out, long long bits,
                                     int n) {
  if (threadIdx.x != 0) return;
  Bucket c{carry[0], carry[1], carry[2]};
  const long long k = kbps[0], m = mbs[0];
  for (int i = 0; i < n; ++i)
    keep[i] = bucket_step(c, pts[i], valid[i], bits, k, m);
  carry_out[0] = c.bucket;
  carry_out[1] = c.prev_time;
  carry_out[2] = c.dropn;
}

// The latency of one step: one thread runs `steps` dependent steps on
// registers (pts and validity made from the loop counter, off the chain)
// and reports the clock cycles they took.  Used for the walk's chain bound.
// The frame's bits and the properties are kernel arguments, as the walk
// reads them at run time: constants would let the compiler fold the
// division by the rate into a multiplication.
__global__ void netsim_cycles_kernel(long long* out, int steps,
                                     long long bits, long long kbps,
                                     long long mbs) {
  Bucket c{mbs * 1000, -1, 3};
  long long kept = 0;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const unsigned h = static_cast<unsigned>(i) * 2654435761u;
    kept += bucket_step(c, static_cast<long long>(i) * 33366666LL +
                               static_cast<long long>(h >> 24),
                        (h & 0x80000000u) == 0 || (h & 7u), bits, kbps,
                        mbs);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = kept + c.bucket + c.prev_time + c.dropn;
}

}  // namespace

extern "C" int gst_netsim_bucket(const void* pts, const void* valid,
                                 const void* kbps, const void* mbs,
                                 const void* carry, void* keep,
                                 void* carry_out, long long bits, int n,
                                 void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  netsim_bucket_kernel<<<1, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(pts), static_cast<const bool*>(valid),
      static_cast<const int*>(kbps), static_cast<const int*>(mbs),
      static_cast<const long long*>(carry), static_cast<bool*>(keep),
      static_cast<long long*>(carry_out), bits, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_netsim_step_cycles(void* out, int steps, void* stream) {
  // netsim_1080p's frame and properties
  netsim_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps, 66355200LL, 1500000LL, 200000LL);
  return static_cast<int>(cudaGetLastError());
}
