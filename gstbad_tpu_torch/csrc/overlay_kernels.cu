// H4: overlay_blend (gstbad_tpu_torch/ops/overlay.py) -- the overlay
// composites of the subtitle, caption, QR, SVG and text renderers in one
// pass over a window of frames [B, H, W, C] u8.  Each frame applies the
// bank entries its row of the [B, L] int32 layer table names (-1 for
// none), in the table's order, each by the integer formula of the
// element (the MODE template argument, ops/overlay.py MODES).  It is not
// a TPU kernel: it replaces the JAX package's whole-window jnp passes,
// one per overlay (gstbad_tpu/elements/video/overlay.py:26-35, :149-158,
// :213-220; closedcaption.py:815-828; qroverlay.py:108-125;
// assrender.py:125-136; ttmlrender.py:86-108; rsvg.py:52-59).
//
// One thread a pixel, a block row of 256 pixels of one frame row (the
// grid is columns x rows x frames, so no thread divides to find its
// pixel): it reads the pixel's C bytes once (one 4-byte word where C is
// 4: the wrapper passes 4-byte aligned frames), walks the layers on
// registers and writes the bytes once, so the window is read and written
// once and each layer's overlay read once.  The alpha plane
// and the three source planes are strided views of the bank (a channel
// of a packed overlay, every other row and column of a plane); a plane
// with shift 1 is read at (y >> 1, x >> 1).  Every operand is a
// non-negative integer under 2^17, so int arithmetic and C division give
// the plain version's floors exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Plane {
  const uint8_t* p;
  long long sk, sy, sx;
  int shift;
};

struct Geometry {
  int b, h, w, c, l;
  Plane alpha;
  Plane src[3];
  int chan[4];      // source of each channel: 0-2 a plane, 3 alpha, -1 none
  int alpha_chan;   // MODE 3's channel that takes the alpha rule, or -1
};

template <int MODE>
__device__ __forceinline__ int blend(int d, int s, int a) {
  if (MODE == 0) return (a * s + (255 - a) * d + 127) / 255;
  if (MODE == 1 || MODE == 3) return (d * (256 - a) + s * a) >> 8;
  if (MODE == 2) return ((255 - a) * d + a * s) / 255;
  if (MODE == 4) {
    const int t = d * (255 - a) + 0x80;
    return min(s + ((t + (t >> 8)) >> 8), 255);
  }
  return min(s + (255 - a) * d / 255, 255);
}

__device__ __forceinline__ int texel(const Plane& q, long long k, int y,
                                     int x) {
  return q.p[k * q.sk + (y >> q.shift) * q.sy + (x >> q.shift) * q.sx];
}

template <int MODE>
__global__ void overlay_blend_kernel(uint8_t* __restrict__ out,
                                     const uint8_t* __restrict__ in,
                                     const int* __restrict__ layers,
                                     Geometry g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= g.w) return;
  const int y = blockIdx.y;
  const int f = blockIdx.z;
  const long long i = (static_cast<long long>(f) * g.h + y) * g.w + x;
  const uint8_t* px = in + i * g.c;
  int v[4];
  if (g.c == 4) {                       // one 4-byte load (aligned)
    const uint32_t word = *reinterpret_cast<const uint32_t*>(px);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (word >> (8 * c)) & 0xFF;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = c < g.c ? px[c] : 0;
  }
  for (int l = 0; l < g.l; ++l) {
    const int k = layers[f * g.l + l];
    if (k < 0) continue;
    const int a = texel(g.alpha, k, y, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= g.c) break;
      const int j = g.chan[c];
      if (j < 0) {
        if (MODE == 3 && c == g.alpha_chan)
          v[c] = (v[c] * (256 - a) + 255 * a) >> 8;
        continue;
      }
      const int s = j == 3 ? a : texel(g.src[j], k, y, x);
      v[c] = blend<MODE>(v[c], s, a);
    }
  }
  uint8_t* po = out + i * g.c;
  if (g.c == 4) {
    *reinterpret_cast<uint32_t*>(po) =
        static_cast<uint32_t>(v[0]) | (static_cast<uint32_t>(v[1]) << 8) |
        (static_cast<uint32_t>(v[2]) << 16) |
        (static_cast<uint32_t>(v[3]) << 24);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < g.c) po[c] = static_cast<uint8_t>(v[c]);
  }
}

template <int MODE>
cudaError_t launch(uint8_t* out, const uint8_t* in, const int* layers,
                   const Geometry& g, cudaStream_t stream) {
  if (g.b == 0 || g.h == 0 || g.w == 0) return cudaSuccess;
  if (g.b > 65535 || g.h > 65535) return cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((g.w + threads - 1) / threads, g.h, g.b);
  overlay_blend_kernel<MODE><<<grid, threads, 0, stream>>>(out, in, layers,
                                                           g);
  return cudaGetLastError();
}

}  // namespace

// chan: byte c is channel c's source (0-2 a plane, 3 the alpha plane,
// 0xFF none); the unused source planes may repeat any valid pointer.
extern "C" cudaError_t gst_overlay_blend(
    void* out, const void* in, const void* layers, const void* alpha,
    const void* s0, const void* s1, const void* s2, long long b,
    long long h, long long w, long long c, long long l, long long a_sk,
    long long a_sy, long long a_sx, long long s0_sk, long long s0_sy,
    long long s0_sx, long long s0_shift, long long s1_sk, long long s1_sy,
    long long s1_sx, long long s1_shift, long long s2_sk, long long s2_sy,
    long long s2_sx, long long s2_shift, long long chan,
    long long alpha_chan, long long mode, cudaStream_t stream) {
  Geometry g;
  g.b = static_cast<int>(b);
  g.h = static_cast<int>(h);
  g.w = static_cast<int>(w);
  g.c = static_cast<int>(c);
  g.l = static_cast<int>(l);
  g.alpha = {static_cast<const uint8_t*>(alpha), a_sk, a_sy, a_sx, 0};
  g.src[0] = {static_cast<const uint8_t*>(s0), s0_sk, s0_sy, s0_sx,
              static_cast<int>(s0_shift)};
  g.src[1] = {static_cast<const uint8_t*>(s1), s1_sk, s1_sy, s1_sx,
              static_cast<int>(s1_shift)};
  g.src[2] = {static_cast<const uint8_t*>(s2), s2_sk, s2_sy, s2_sx,
              static_cast<int>(s2_shift)};
  for (int i = 0; i < 4; ++i) {
    const int j = static_cast<int>((chan >> (8 * i)) & 0xFF);
    g.chan[i] = j == 0xFF ? -1 : j;
  }
  g.alpha_chan = static_cast<int>(alpha_chan);
  auto* o = static_cast<uint8_t*>(out);
  auto* x = static_cast<const uint8_t*>(in);
  auto* t = static_cast<const int*>(layers);
  switch (mode) {
    case 0: return launch<0>(o, x, t, g, stream);
    case 1: return launch<1>(o, x, t, g, stream);
    case 2: return launch<2>(o, x, t, g, stream);
    case 3: return launch<3>(o, x, t, g, stream);
    case 4: return launch<4>(o, x, t, g, stream);
    case 5: return launch<5>(o, x, t, g, stream);
    default: return cudaErrorInvalidValue;
  }
}
