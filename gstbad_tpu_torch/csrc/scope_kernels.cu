// The scopes' two-stage resonant filter (gstbad_tpu_torch/ops/audio.py
// scope_filter; gstwavescope.c:302-310, gstspacescope.c:263-283) as a
// float64 walk over a window's samples.  It replaces the JAX package's
// lax.scan (gstbad_tpu/elements/audio/visualizers.py:228 and :381), not a
// TPU kernel; its plain version in ops/audio.py holds it bit for bit.
// What bounds it is the chain: one thread per channel walks the window's
// samples in order, six dependent float64 operations a sample
// (gst_scope_step_cycles measures a step as the walker below runs it);
// the bytes are few.  A walk that loads x from global memory and stores
// its three taps there each step runs at about four times the chain, the
// load the larger part (PERF.md section 6): here the walker touches
// shared memory only, x read a group of samples ahead, while three other
// warps move chunks of x in and of taps out through two rings, one
// barrier a chunk.  What it still pays beside the chain: its shared
// loads and tap stores and a barrier a chunk.
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

constexpr int kScopeThreads = 128;   // warp 0 walks, warps 1-3 move data
constexpr int kScopeSlot = 512;      // samples x channels a chunk holds
constexpr int kGroup = 8;            // samples a walker reads ahead

// The samples of a chunk a walker lane takes: its channel's x of samples
// j .. j + kGroup - 1 (clamped to the chunk's last), from shared memory.
__device__ __forceinline__ void read_group(const int* xs, int j, int m,
                                           int ch, int c, int (&v)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) v[u] = xs[min(j + u, m - 1) * ch + c];
}

__device__ __forceinline__ void put_taps(double* tp, int j, int ch, int c,
                                         const ScopeState& f) {
  double* t = tp + j * 3 * ch + c;
  t[0] = f.f0;
  t[ch] = f.f3;
  t[2 * ch] = __dadd_rn(f.f4, f.f5);
}

// One block: lanes 0..C-1 of warp 0 walk their channels through the
// window in chunks of k samples; x comes from a shared-memory ring and the
// taps go into one, so the walker issues its chain and shared loads and
// stores only.  Warps 1-3 fill the ring with the next chunk of x and
// drain the last chunk's taps to global memory in 16-byte stores; one
// barrier a chunk hands the two rings over.
__global__ void __launch_bounds__(kScopeThreads)
scope_filter_kernel(const double* st, const int* x, double* taps,
                    double* st_out, int n, int ch) {
  __shared__ int s_x[2][kScopeSlot];
  __shared__ __align__(16) double s_taps[2][3 * kScopeSlot];
  const int k = (kScopeSlot / ch) & ~1;   // even: a chunk's taps 16-aligned
  const int n_chunks = (n + k - 1) / k;
  const int tid = threadIdx.x, helper = tid - 32;
  const int n_help = kScopeThreads - 32;
  const bool aligned = (reinterpret_cast<size_t>(taps) & 15) == 0;

  auto load = [&](int kc) {
    const int m = min(k, n - kc * k) * ch;
    const int* src = x + static_cast<size_t>(kc) * k * ch;
    int* dst = s_x[kc & 1];
    for (int i = helper; i < m; i += n_help) dst[i] = __ldg(src + i);
  };
  auto drain = [&](int kc) {
    const int m = min(k, n - kc * k) * 3 * ch;
    const double* src = s_taps[kc & 1];
    double* dst = taps + static_cast<size_t>(kc) * k * 3 * ch;
    if (aligned) {
      const double2* s2 = reinterpret_cast<const double2*>(src);
      double2* d2 = reinterpret_cast<double2*>(dst);
      for (int i = helper; i < m / 2; i += n_help) d2[i] = s2[i];
      if ((m & 1) && helper == 0) dst[m - 1] = src[m - 1];
    } else {
      for (int i = helper; i < m; i += n_help) dst[i] = src[i];
    }
  };

  if (helper >= 0 && n_chunks > 0) load(0);
  ScopeState f{};
  const int c = tid;
  if (tid < ch)
    f = ScopeState{st[6 * c], st[6 * c + 1], st[6 * c + 2],
                   st[6 * c + 3], st[6 * c + 4], st[6 * c + 5]};
  __syncthreads();
  for (int kc = 0; kc < n_chunks; ++kc) {
    if (tid < ch) {
      const int m = min(k, n - kc * k);
      const int* xs = s_x[kc & 1];
      double* tp = s_taps[kc & 1];
      int cur[kGroup], nxt[kGroup];
      read_group(xs, 0, m, ch, c, cur);
      int j = 0;
      for (; j + kGroup <= m; j += kGroup) {
        read_group(xs, j + kGroup, m, ch, c, nxt);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          scope_step(static_cast<double>(cur[u]), f);
          put_taps(tp, j + u, ch, c, f);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) cur[u] = nxt[u];
      }
      for (int u = 0; j + u < m; ++u) {
        scope_step(static_cast<double>(xs[(j + u) * ch + c]), f);
        put_taps(tp, j + u, ch, c, f);
      }
    } else if (helper >= 0) {
      if (kc > 0) drain(kc - 1);
      if (kc + 1 < n_chunks) load(kc + 1);
    }
    __syncthreads();
  }
  if (helper >= 0 && n_chunks > 0) drain(n_chunks - 1);
  if (tid < ch) {
    double* so = st_out + 6 * c;
    so[0] = f.f0;
    so[1] = f.f1;
    so[2] = f.f2;
    so[3] = f.f3;
    so[4] = f.f4;
    so[5] = f.f5;
  }
}

// The latency of the walker's step: one thread runs `steps` (a multiple
// of kGroup) dependent steps as scope_filter_kernel's walker runs them,
// kGroup to an unrolled group, with the group's x already in registers
// and no stores, and reports the clock cycles they took.  Used for
// scope_filter's chain bound.
__global__ void scope_cycles_kernel(long long* out, int steps) {
  ScopeState f{1.0 + threadIdx.x, 0.5, 0.25, 0.125, 0.0625, 0.03125};
  int v[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u)
    v[u] = static_cast<int>(((u + steps) * 2654435761u) >> 16);
  const long long t0 = clock64();
  for (int i = 0; i < steps; i += kGroup) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) scope_step(static_cast<double>(v[u]), f);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = static_cast<long long>(f.f0 + f.f3);
}

}  // namespace

extern "C" int gst_scope_filter(const void* st, const void* x, void* taps,
                                void* st_out, int n, int ch, void* stream) {
  if (ch < 1 || ch > 32) return static_cast<int>(cudaErrorInvalidValue);
  scope_filter_kernel<<<1, kScopeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(st), static_cast<const int*>(x),
      static_cast<double*>(taps), static_cast<double*>(st_out), n, ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_scope_step_cycles(void* out, int steps, void* stream) {
  scope_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
