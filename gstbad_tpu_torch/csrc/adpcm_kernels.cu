// The per-sample walks of the ADPCM codecs (gstbad_tpu_torch/ops/audio.py
// adpcm_ima_decode, adpcm_ms_decode, adpcm_ima_encode).  None replaces a
// TPU kernel: each replaces a lax.scan of the JAX package
// (gstbad_tpu/ops/audio.py:1442, :1485, :1532).  Each thread walks one
// serial recurrence from start to end, in the C's order; the plain
// versions in ops/audio.py hold them bit for bit.  What bounds them is
// the chain: a block's codes (the decoders, one thread per block and
// channel) or the whole window's samples (the encoder, whose step index
// carries across blocks: one thread per channel) one dependent step after
// another; gst_adpcm_step_cycles measures a step.  The bytes are few.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__constant__ int kImaStep[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};
__constant__ int kImaAdjust[16] = {-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8};
__constant__ int kMsAdapt[16] = {230, 230, 230, 230, 307, 409, 512, 614, 768, 614, 512, 409, 307, 230, 230, 230};
__constant__ int kMsCoef1[7] = {256, 512, 0, 192, 240, 460, 392};
__constant__ int kMsCoef2[7] = {0, -256, 0, 64, 0, -208, -232};

constexpr int kThreads = 128;

__device__ __forceinline__ int wrap16(int v) {
  return ((v + 32768) & 0xFFFF) - 32768;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int rd16(const uint8_t* p, int off) {
  return wrap16(p[off] | (p[off + 1] << 8));
}

// One IMA step: the step size's share of the code, the clamped sample and
// the clamped step index (adpcmdec.c:302-328).
__device__ __forceinline__ void ima_step(int code, int& s, int& si) {
  const int stepv = kImaStep[si];
  int diff = (2 * (code & 7) * stepv + stepv) >> 3;
  if (code & 8) diff = -diff;
  s = clampi(s + diff, -32768, 32767);
  si = clampi(si + kImaAdjust[code], 0, 88);
}

// One MS step: the 16-bit-wrapped adapted delta (its floor of 16 after
// the wrap), the predictor and the clamped sample (adpcmdec.c:180-252).
__device__ __forceinline__ int ms_step(int code, int& s1, int& s2, int& delta,
                                       int coef1, int coef2) {
  const int nd = wrap16((kMsAdapt[code] * delta) >> 8);
  const int sgn = code - ((code & 8) ? 16 : 0);
  const int predict = (s1 * coef1 + s2 * coef2) >> 8;
  const int cur = clampi(sgn * delta + predict, -32768, 32767);
  s2 = s1;
  s1 = cur;
  delta = max(nd, 16);
  return cur;
}

// One IMA encoder step (adpcmenc's 3-bit magnitude search): returns the
// code, updates prev and the step index.
__device__ __forceinline__ int ima_encode_step(int s, int& prev, int& si) {
  int diff = s - prev;
  const bool sign = diff < 0;
  if (sign) diff = -diff;
  int stepv = kImaStep[clampi(si, 0, 88)];
  int vpdiff = stepv >> 3;
  int code = 0;
#pragma unroll
  for (int bit = 4; bit; bit >>= 1) {
    if (diff >= stepv) {
      code |= bit;
      diff -= stepv;
      vpdiff += stepv;
    }
    stepv >>= 1;
  }
  if (sign) {
    code |= 8;
    vpdiff = -vpdiff;
  }
  prev = clampi(prev + vpdiff, -32768, 32767);
  si = clampi(si + kImaAdjust[code], 0, 88);
  return code;
}

// One thread per (block, channel): the header's sample and step index,
// then the channel's 4-byte chunks of each group, low nibble first.
__global__ void __launch_bounds__(kThreads) ima_decode_kernel(
    const uint8_t* blocks, int16_t* out, int nb, int bsz, int ch) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * ch) return;
  const int b = t / ch, c = t % ch;
  const uint8_t* blk = blocks + static_cast<size_t>(b) * bsz;
  const int groups = (bsz - 4 * ch) / (4 * ch);
  int16_t* o = out + static_cast<size_t>(b) * (1 + 8 * groups) * ch + c;
  int s = rd16(blk, 4 * c);
  int si = min(static_cast<int>(blk[4 * c + 2]), 88);
  o[0] = static_cast<int16_t>(s);
  size_t k = ch;
  for (int g = 0; g < groups; ++g) {
    const uint8_t* p = blk + 4 * ch + (g * ch + c) * 4;
    const uint32_t word = p[0] | (p[1] << 8) | (p[2] << 16) |
                          (static_cast<uint32_t>(p[3]) << 24);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ima_step((word >> (4 * j)) & 15, s, si);
      o[k] = static_cast<int16_t>(s);
      k += ch;
    }
  }
}

// One thread per (block, channel): the header's predictor, delta and two
// samples, then the channel's nibbles (high nibble first) in order.
__global__ void __launch_bounds__(kThreads) ms_decode_kernel(
    const uint8_t* blocks, int16_t* out, int nb, int bsz, int ch) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nb * ch) return;
  const int b = t / ch, c = t % ch;
  const uint8_t* blk = blocks + static_cast<size_t>(b) * bsz;
  const int data_off = 7 * ch;
  const int steps = (bsz - data_off) * 2 / ch;
  int16_t* o = out + static_cast<size_t>(b) * (2 + steps) * ch + c;
  // the gather of the JAX package clamps a predictor index past the table
  const int pred = min(static_cast<int>(blk[c]), 6);
  int delta = rd16(blk, ch + 2 * c);
  int s1 = rd16(blk, 3 * ch + 2 * c);
  int s2 = rd16(blk, 5 * ch + 2 * c);
  const int coef1 = kMsCoef1[pred], coef2 = kMsCoef2[pred];
  o[0] = static_cast<int16_t>(s2);
  o[ch] = static_cast<int16_t>(s1);
  const uint8_t* body = blk + data_off;
  for (int p = 0; p < steps; ++p) {
    const int nib = p * ch + c;
    const int byte = body[nib >> 1];
    const int code = (nib & 1) ? (byte & 15) : ((byte >> 4) & 15);
    o[static_cast<size_t>(2 + p) * ch] =
        static_cast<int16_t>(ms_step(code, s1, s2, delta, coef1, coef2));
  }
}

// One thread per channel walks the window's samples in order: prev resets
// to each block's first sample, the step index carries across blocks.
__global__ void ima_encode_kernel(const int16_t* x, const int* si0,
                                  int* codes, int* header, int* final_si,
                                  int nb, int n, int ch) {
  const int c = threadIdx.x;
  if (c >= ch) return;
  int prev = 0, si = si0[c];
  for (int b = 0; b < nb; ++b) {
    const size_t base = static_cast<size_t>(b) * n * ch + c;
    header[b * ch + c] = si;
    prev = x[base];
    codes[base] = 0;
    for (int i = 1; i < n; ++i) {
      const size_t idx = base + static_cast<size_t>(i) * ch;
      codes[idx] = ima_encode_step(x[idx], prev, si);
    }
  }
  final_si[c] = si;
}

// A code or sample made from the loop counter alone: like the bytes the
// walks read, it never depends on the carried state.
__device__ __forceinline__ unsigned probe_hash(int i) {
  return static_cast<unsigned>(i) * 2654435761u;
}

// The latency of each walk's step: one thread runs `steps` dependent steps
// on registers (inputs made from the loop counter, off the chain) and
// reports the clock cycles they took.  kind 0: IMA decode, 1: MS decode,
// 2: IMA encode.  Used for the walks' chain bounds.
__global__ void adpcm_cycles_kernel(long long* out, int steps, int kind) {
  long long t0 = 0, t1 = 0;
  long long sink = 0;
  if (kind == 0) {
    int s = threadIdx.x, si = 40;
    t0 = clock64();
    for (int i = 0; i < steps; ++i) ima_step(probe_hash(i) >> 28, s, si);
    t1 = clock64();
    sink = s + si;
  } else if (kind == 1) {
    int s1 = threadIdx.x, s2 = 3, delta = 100;
    t0 = clock64();
    for (int i = 0; i < steps; ++i)
      ms_step(probe_hash(i) >> 28, s1, s2, delta, 460, -208);
    t1 = clock64();
    sink = s1 + s2 + delta;
  } else if (kind == 2) {
    int prev = threadIdx.x, si = 40;
    t0 = clock64();
    for (int i = 0; i < steps; ++i)
      sink += ima_encode_step(static_cast<int>(probe_hash(i) >> 16) - 32768,
                              prev, si);
    t1 = clock64();
    sink += prev + si;
  }
  out[0] = t1 - t0;
  out[1] = sink;
}

cudaError_t grid_launch(void (*kernel)(const uint8_t*, int16_t*, int, int,
                                       int),
                        const void* blocks, void* out, int nb, int bsz,
                        int ch, void* stream) {
  const int threads = nb * ch;
  kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<int16_t*>(out), nb,
      bsz, ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gst_adpcm_ima_decode(const void* blocks, void* out, int nb,
                                    int bsz, int ch, void* stream) {
  if (ch < 1 || ch > 2 || bsz < 4 * ch)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      grid_launch(ima_decode_kernel, blocks, out, nb, bsz, ch, stream));
}

extern "C" int gst_adpcm_ms_decode(const void* blocks, void* out, int nb,
                                   int bsz, int ch, void* stream) {
  if (ch < 1 || ch > 2 || bsz < 7 * ch || ((bsz - 7 * ch) * 2) % ch)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      grid_launch(ms_decode_kernel, blocks, out, nb, bsz, ch, stream));
}

extern "C" int gst_adpcm_ima_encode(const void* x, const void* si0,
                                    void* codes, void* header, void* final_si,
                                    int nb, int n, int ch, void* stream) {
  if (ch < 1 || ch > 32 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  ima_encode_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const int*>(si0),
      static_cast<int*>(codes), static_cast<int*>(header),
      static_cast<int*>(final_si), nb, n, ch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_adpcm_step_cycles(void* out, int steps, int kind,
                                     void* stream) {
  adpcm_cycles_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), steps, kind);
  return static_cast<int>(cudaGetLastError());
}
