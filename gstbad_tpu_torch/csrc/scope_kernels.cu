// The scopes' two-stage resonant filter (gstbad_tpu_torch/ops/audio.py
// scope_filter; gstwavescope.c:302-310, gstspacescope.c:263-283) as a
// float64 walk over a window's samples.  It replaces the JAX package's
// lax.scan (gstbad_tpu/elements/audio/visualizers.py:228 and :381), not a
// TPU kernel; its plain version in ops/audio.py holds it bit for bit.
// What bounds it is the chain: one thread per channel walks the window's
// samples in order, six dependent float64 operations a sample
// (gst_scope_step_cycles measures a step); the bytes are few.
#include <cuda_runtime.h>

namespace {

// The filter's update (gstwavescope.c:302-310): `carry + value * k` as one
// FMA each, as the JAX package's compiled scan contracts it; every other
// product and sum rounded on its own.
struct ScopeState {
  double f0, f1, f2, f3, f4, f5;
};

__device__ __forceinline__ void scope_step(double inp, ScopeState& f) {
  f.f2 = __dsub_rn(__dsub_rn(inp, __dmul_rn(f.f1, 2.0)), f.f0);
  f.f1 = __fma_rn(f.f2, 0.15, f.f1);
  f.f0 = __fma_rn(f.f1, 0.15, f.f0);
  f.f5 = __dsub_rn(__dsub_rn(__dadd_rn(f.f1, f.f2), __dmul_rn(f.f4, 2.0)),
                   f.f3);
  f.f4 = __fma_rn(f.f5, 0.45, f.f4);
  f.f3 = __fma_rn(f.f4, 0.45, f.f3);
}

// One thread per channel walks the window's samples in order.
__global__ void scope_filter_kernel(const double* st, const int* x,
                                    double* taps, double* st_out, int n,
                                    int ch) {
  const int c = threadIdx.x;
  if (c >= ch) return;
  ScopeState f{st[6 * c], st[6 * c + 1], st[6 * c + 2],
               st[6 * c + 3], st[6 * c + 4], st[6 * c + 5]};
  for (int i = 0; i < n; ++i) {
    scope_step(static_cast<double>(x[static_cast<size_t>(i) * ch + c]), f);
    double* tp = taps + static_cast<size_t>(i) * 3 * ch + c;
    tp[0] = f.f0;
    tp[ch] = f.f3;
    tp[2 * ch] = __dadd_rn(f.f4, f.f5);
  }
  double* so = st_out + 6 * c;
  so[0] = f.f0;
  so[1] = f.f1;
  so[2] = f.f2;
  so[3] = f.f3;
  so[4] = f.f4;
  so[5] = f.f5;
}

// The latency of the filter's step: one thread runs `steps` dependent steps
// on registers and reports the clock cycles they took.  Used for
// scope_filter's chain bound.
__global__ void scope_cycles_kernel(long long* out, int steps) {
  ScopeState f{1.0 + threadIdx.x, 0.5, 0.25, 0.125, 0.0625, 0.03125};
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i)
    scope_step(static_cast<double>((i * 2654435761u) >> 16), f);
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = static_cast<long long>(f.f0 + f.f3);
}

}  // namespace

extern "C" int gst_scope_filter(const void* st, const void* x, void* taps,
                                void* st_out, int n, int ch, void* stream) {
  if (ch < 1 || ch > 32) return static_cast<int>(cudaErrorInvalidValue);
  scope_filter_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(st), static_cast<const int*>(x),
      static_cast<double*>(taps), static_cast<double*>(st_out), n, ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_scope_step_cycles(void* out, int steps, void* stream) {
  scope_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
