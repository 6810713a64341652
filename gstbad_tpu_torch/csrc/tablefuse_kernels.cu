// Hand-written Hopper kernels of the table-fusion layer
// (gstbad_tpu_torch/core/tablefuse.py).  Plain C entry points, loaded with
// ctypes by gstbad_tpu_torch/ops/_cuda.py; each launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libgstbad_kernels.so tablefuse_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K2: whole-word table lookup, out[i] = table[idx[i]].
//
// Replaces gstbad_tpu/ops/lut.py:_word_lut_kernel (the TPU's 128-lane
// shuffle on a two-vreg table).  Here it is a gather from a 1 KB table in
// shared memory.  Bound: device memory, 8 bytes per element (read the
// index, write the word); measured about 2.8 TB/s of that on an H100 SXM
// (700 W), 85% of its peak.  Design: each block stages the table once and
// then walks a grid-stride loop of 16-byte int4 loads and stores, so the
// table load is amortised over many elements and every access is a full
// vector.  The shared-memory gathers are 4 per vector; bank conflicts
// among random indices cost far less than the memory traffic.
// ---------------------------------------------------------------------------

constexpr int kLutThreads = 256;
constexpr int kLutMaxBlocks = 4096;

__global__ void word_lut_kernel(const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ table,
                                int32_t* __restrict__ out, long long n,
                                int vec) {
  __shared__ int32_t s_table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? (n >> 2) : 0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < n4; i += stride) {
    const int4 v = idx4[i];
    int4 r;
    // & 255 keeps a bad index inside the shared table
    r.x = s_table[v.x & 255];
    r.y = s_table[v.y & 255];
    r.z = s_table[v.z & 255];
    r.w = s_table[v.w & 255];
    out4[i] = r;
  }
  for (long long i = (n4 << 2) + first; i < n; i += stride) {
    out[i] = s_table[idx[i] & 255];
  }
}

// ---------------------------------------------------------------------------
// K1: the fused headline tail, out = zebra(word_table[dilate3(idx)]) with
// idx = index(src word).
//
// Replaces gstbad_tpu/ops/chainfuse.py:_kernel.  The TPU kernel traced a
// Python index_fn into its body; here the chain head's index is a linear
// descriptor (tablefuse.LinearIndex): four weights, a pre-shift and a
// post-shift, so idx = (sum_c (byte_c << pre) * w_c) >> post, exact in
// int32 (the descriptor checks its own range).
//
// Bound: by bytes, device memory.  Per output pixel the kernel writes 4
// bytes and reads the source word once (the neighbours come from
// registers and warp shuffles).  In broadcast mode (src [1, H, W], B
// output frames: the static videotestsrc patterns) the one source frame
// is read once and the minimum traffic is the output write alone.  The
// integer work, on the INT32 pipe (64 lanes an SM), stays far below the
// bytes: the first version spent about 70 instructions a pixel (three
// index computations of a dozen each, four rank lookups, one column a
// thread with scalar loads) and redid the whole dilate for every frame of
// a broadcast base.
//
// Design: a lane owns four neighbouring columns (one 16-byte load and
// store a row; rows that are not 16-byte aligned, W % 4 != 0, take a
// scalar path) and each warp walks a strip of rows top to bottom, loading
// the row below one row ahead.  A pixel's index is computed once, when
// its row is the row below: __dp4a of the word and the weights' low
// bytes, plus three more __dp4a for the weights' higher bytes when a
// weight exceeds 255 ((b << pre) w = (b w) << pre, and the sum is exact
// mod 2^32 inside the descriptor's range), then two shifts and a mask to
// 4 idx.  It then looks up its key, (rank << 12) | (4 idx), once; the row
// below becomes the next row's centre.  The left and right neighbours'
// keys come from the lane's own registers or the next lane's by one
// shuffle each way; lanes 0 and 31 load the key of the column beyond the
// warp with the row ahead.  The sequential walk down -> right -> left
// with strict comparisons (gstdilate.c:273-350) keeps the first of the
// largest ranks in that order, so it is the maximum of four keys that
// carry their position, centre 3, down 2, right 1, left 0, in bits 10-11:
// three IMNMX.  Erode takes the smallest rank: 255 - rank, an XOR of the
// rank bits per frame, turns it into the largest and keeps ties.  Edge
// replication: the last row is its own down neighbour (the reference's
// dead `up` pointer means no up neighbour), the first and last columns
// their own left and right.  In broadcast mode a row's keys serve every
// frame: the maximum and the word lookup are redone only where a frame's
// erode differs from the one before, and each frame adds only its stripe
// select and its store.  Any H, W >= 1; the ranks are those of
// TableChain.rank_table, in [0, 256).
// ---------------------------------------------------------------------------

constexpr int kChainWarps = 4;      // warps per block, one row strip each
constexpr int kLaneCols = 4;        // columns per lane
constexpr int kWarpCols = 32 * kLaneCols;
constexpr int kChainRows = 16;      // rows a warp walks (materialized)
constexpr int kChainRowsBcast = 8;  // (broadcast: more warps store frames)
constexpr uint32_t kRankBits = 0xFFu << 12;

struct ChainIndex {
  uint32_t w[4];   // byte j of the four weights, packed for __dp4a
  int lsh, rsh;    // 4 idx = ((sum << lsh) >> rsh) & 0x3FC
};

template <bool kWide>
__device__ __forceinline__ uint32_t index_addr(int32_t word,
                                               const ChainIndex& ci) {
  const uint32_t u = static_cast<uint32_t>(word);
  uint32_t acc = __dp4a(u, ci.w[0], 0u);
  if (kWide) {
    acc += __dp4a(u, ci.w[1], 0u) << 8;
    acc += __dp4a(u, ci.w[2], 0u) << 16;
    acc += __dp4a(u, ci.w[3], 0u) << 24;
  }
  return ((acc << ci.lsh) >> ci.rsh) & 0x3FCu;
}

template <bool kVec>
__device__ __forceinline__ void load_row(const int32_t* line, int c0, int W,
                                         int32_t (&w)[kLaneCols]) {
  if (kVec) {
    const int4 v = c0 < W ? *reinterpret_cast<const int4*>(line + c0)
                          : make_int4(0, 0, 0, 0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
      w[j] = c0 + j < W ? line[c0 + j] : 0;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(int32_t* line, int c0, int W,
                                          const uint32_t (&w)[kLaneCols]) {
  if (kVec) {
    if (c0 < W)
      *reinterpret_cast<int4*>(line + c0) =
          make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                    static_cast<int>(w[2]), static_cast<int>(w[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j)
      if (c0 + j < W) line[c0 + j] = static_cast<int32_t>(w[j]);
  }
}

template <bool kWide, bool kVec>
__global__ void __launch_bounds__(32 * kChainWarps)
dilate_zebra_kernel(const int32_t* __restrict__ src,
                    int32_t* __restrict__ out,
                    const int32_t* __restrict__ rank_table,
                    const int32_t* __restrict__ word_table,
                    const int32_t* __restrict__ scal, int B, int H, int W,
                    int rows, int bcast, ChainIndex ci) {
  __shared__ uint32_t s_key[256];
  __shared__ uint32_t s_word[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_key[i] = (static_cast<uint32_t>(rank_table[i] & 255) << 12) | (i << 2);
    s_word[i] = static_cast<uint32_t>(word_table[i]);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.y * kChainWarps + threadIdx.x / 32) * rows;
  if (r0 >= H) return;   // the whole warp
  const int r1 = min(r0 + rows, H);
  const int c0 = blockIdx.x * kWarpCols + kLaneCols * lane;
  const int f0 = bcast ? 0 : blockIdx.z, f1 = bcast ? B : blockIdx.z + 1;
  const size_t plane = static_cast<size_t>(H) * W;
  const int32_t* s = src + (bcast ? 0 : plane * f0);
  // lanes 0 and 31 also read the column just beyond the warp
  const int hc = lane == 0 ? c0 - 1 : c0 + kLaneCols;
  const bool halo = (lane == 0 || lane == 31) && hc >= 0 && hc < W;
  const char* key_bytes = reinterpret_cast<const char*>(s_key);
  const char* word_bytes = reinterpret_cast<const char*>(s_word);
  auto key_of = [&](int32_t word) {
    return *reinterpret_cast<const uint32_t*>(
        key_bytes + index_addr<kWide>(word, ci));
  };

  int32_t w[kLaneCols], halo_w;
  auto fetch = [&](int r) {   // row r's words and halo word
    const int32_t* line = s + static_cast<size_t>(min(r, H - 1)) * W;
    load_row<kVec>(line, c0, W, w);
    halo_w = halo ? line[hc] : 0;
  };
  uint32_t cur[kLaneCols], down[kLaneCols];
  fetch(r0);
#pragma unroll
  for (int j = 0; j < kLaneCols; ++j) cur[j] = key_of(w[j]);
  uint32_t halo_k = key_of(halo_w);
  fetch(r0 + 1);

  for (int r = r0; r < r1; ++r) {
    // neighbours of row r: below (loaded last step), right and left
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) down[j] = key_of(w[j]);
    const uint32_t halo_down = key_of(halo_w);
    if (r + 1 < r1) fetch(r + 2);
    uint32_t right[kLaneCols], left[kLaneCols];
    const uint32_t from_right = __shfl_down_sync(~0u, cur[0], 1);
    const uint32_t from_left = __shfl_up_sync(~0u, cur[kLaneCols - 1], 1);
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
      right[j] = j + 1 < kLaneCols ? cur[j + 1]
                 : (halo && lane == 31) ? halo_k : from_right;
      left[j] = j > 0 ? cur[j - 1] : (halo && lane == 0) ? halo_k : from_left;
      if (c0 + j == W - 1) right[j] = cur[j];
    }
    if (c0 == 0) left[0] = cur[0];

    int32_t* o_row = out + static_cast<size_t>(r) * W;
    uint32_t word[kLaneCols] = {0, 0, 0, 0};
    uint32_t e_prev = 1;   // no frame's mask
    for (int f = f0; f < f1; ++f) {
      // scal is [3, B]: erode flag, luma threshold, stripe phase per frame
      const uint32_t e = scal[f] != 0 ? kRankBits : 0u;
      if (e != e_prev) {
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          const uint32_t best =
              max(max((cur[j] ^ e) | 0xC00u, (down[j] ^ e) | 0x800u),
                  max((right[j] ^ e) | 0x400u, left[j] ^ e));
          word[j] = *reinterpret_cast<const uint32_t*>(word_bytes +
                                                       (best & 0x3FCu));
        }
        e_prev = e;
      }
      const int thr = scal[B + f];
      // gstzebrastripe.c:205-253: ((col + row + t) & 4) && Y >= thr -> Y = 16
      const uint32_t st = static_cast<uint32_t>(c0) +
                          static_cast<uint32_t>(r) +
                          static_cast<uint32_t>(scal[2 * B + f]);
      uint32_t o[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const bool zebra = ((st + j) & 4u) != 0 &&
                           static_cast<int>((word[j] >> 8) & 255u) >= thr;
        o[j] = zebra ? (word[j] & 0xFFFF00FFu) | (16u << 8) : word[j];
      }
      store_row<kVec>(o_row + plane * f, c0, W, o);
    }
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) cur[j] = down[j];
    halo_k = halo_down;
  }
}

template <bool kWide, bool kVec>
cudaError_t launch_dilate_zebra(const dim3& grid, cudaStream_t stream,
                                const int32_t* src, int32_t* out,
                                const int32_t* rank_table,
                                const int32_t* word_table,
                                const int32_t* scal, int B, int H, int W,
                                int rows, int bcast, const ChainIndex& ci) {
  dilate_zebra_kernel<kWide, kVec><<<grid, 32 * kChainWarps, 0, stream>>>(
      src, out, rank_table, word_table, scal, B, H, W, rows, bcast, ci);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gst_word_lut(const void* idx, const void* table, void* out,
                            long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int vec = (reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kLutThreads - 1) / kLutThreads;
  if (blocks > kLutMaxBlocks) blocks = kLutMaxBlocks;
  word_lut_kernel<<<static_cast<unsigned>(blocks), kLutThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(table),
      static_cast<int32_t*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gst_dilate_zebra(const void* src, void* out,
                                const void* rank_table,
                                const void* word_table, const void* scal,
                                int B, int H, int W, int bcast, int w0, int w1,
                                int w2, int w3, int pre, int post,
                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  ChainIndex ci{};
  const uint32_t weights[4] = {static_cast<uint32_t>(w0),
                               static_cast<uint32_t>(w1),
                               static_cast<uint32_t>(w2),
                               static_cast<uint32_t>(w3)};
  bool wide = false;
  for (int c = 0; c < 4; ++c) {
    wide = wide || weights[c] > 255u;
    for (int j = 0; j < 4; ++j)
      ci.w[j] |= ((weights[c] >> (8 * j)) & 255u) << (8 * c);
  }
  // 4 idx = ((sum << pre) >> post) << 2, as one left and one right shift
  const int d = post - pre;
  ci.lsh = d >= 2 ? 0 : 2 - d;
  ci.rsh = d >= 2 ? d - 2 : 0;
  const bool vec = W % kLaneCols == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int rows = bcast ? kChainRowsBcast : kChainRows;
  const dim3 grid((W + kWarpCols - 1) / kWarpCols,
                  (H + kChainWarps * rows - 1) / (kChainWarps * rows),
                  bcast ? 1 : B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(src);
  auto* o = static_cast<int32_t*>(out);
  const auto* rk = static_cast<const int32_t*>(rank_table);
  const auto* wt = static_cast<const int32_t*>(word_table);
  const auto* sc = static_cast<const int32_t*>(scal);
  cudaError_t e;
  if (wide)
    e = vec ? launch_dilate_zebra<true, true>(grid, st, s, o, rk, wt, sc, B,
                                              H, W, rows, bcast, ci)
            : launch_dilate_zebra<true, false>(grid, st, s, o, rk, wt, sc, B,
                                               H, W, rows, bcast, ci);
  else
    e = vec ? launch_dilate_zebra<false, true>(grid, st, s, o, rk, wt, sc, B,
                                               H, W, rows, bcast, ci)
            : launch_dilate_zebra<false, false>(grid, st, s, o, rk, wt, sc,
                                                B, H, W, rows, bcast, ci);
  return static_cast<int>(e);
}
