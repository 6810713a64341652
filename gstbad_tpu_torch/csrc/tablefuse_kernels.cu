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
// descriptor (tablefuse.LinearIndex): four byte weights, a pre-shift and a
// post-shift, so idx = (sum_c (byte_c << pre) * w_c) >> post, exact in
// int32 (the descriptor checks its own range).
//
// Bound: by bytes, device memory.  Per output pixel the kernel writes 4
// bytes; it reads the source word of the pixel and of its down, right and
// left neighbours, which are the same lines a warp's neighbours read, so
// they come from L1/L2 and device memory sees each source word about once.
// In broadcast mode (src [1, H, W], B output frames: the static
// videotestsrc patterns) the one source frame (8 MB at 1080p) stays in the
// 50 MB L2 while all B frames are written, so the minimum traffic is the
// output write alone.  Measured on an H100 SXM (700 W), this simple form
// reaches about 690 GB/s of that minimum and is no faster in broadcast
// mode than materialized: it is bound by instruction latency (four index
// computations and a dependent three-step walk per pixel, rows walked in
// sequence), not by memory.  Vector loads and warp shuffles for the left
// and right neighbours are the next step.
//
// Design: one thread per column of a 32-row strip.  Each thread walks its
// strip top to bottom, so the down neighbour's index of row r is the centre
// of row r + 1 and is computed once.  Both 256-entry tables (rank, word)
// sit in shared memory.  The neighbour walk is the reference's sequential
// down -> right -> left (gstdilate.c:273-350) with strict comparisons and
// edge replication: the last row is its own down neighbour (the reference's
// dead `up` pointer means no up neighbour), the first and last columns
// their own left and right.  Ragged edges are masked, so any H, W >= 1.
// ---------------------------------------------------------------------------

constexpr int kChainThreads = 128;   // columns per block
constexpr int kChainRows = 32;       // rows each thread walks

struct LinearIndex {
  int w0, w1, w2, w3, pre, post;
};

__device__ __forceinline__ int index_of(int32_t word, const LinearIndex& li) {
  const uint32_t u = static_cast<uint32_t>(word);
  const int b0 = u & 255u, b1 = (u >> 8) & 255u, b2 = (u >> 16) & 255u,
            b3 = u >> 24;
  const int acc = (b0 << li.pre) * li.w0 + (b1 << li.pre) * li.w1 +
                  (b2 << li.pre) * li.w2 + (b3 << li.pre) * li.w3;
  return (acc >> li.post) & 255;  // in range by construction; & 255 guards
}

__global__ void dilate_zebra_kernel(const int32_t* __restrict__ src,
                                    int32_t* __restrict__ out,
                                    const int32_t* __restrict__ rank_table,
                                    const int32_t* __restrict__ word_table,
                                    const int32_t* __restrict__ scal,
                                    int B, int H, int W, int bcast,
                                    LinearIndex li) {
  __shared__ int32_t s_rank[256];
  __shared__ int32_t s_word[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_rank[i] = rank_table[i];
    s_word[i] = word_table[i];
  }
  __syncthreads();

  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row0 = blockIdx.y * kChainRows;
  const int f = blockIdx.z;
  if (col >= W || row0 >= H) return;
  // scal is [3, B]: erode flag, luma threshold, stripe phase per frame
  const bool erode = scal[f] != 0;
  const int thr = scal[B + f];
  const uint32_t phase = static_cast<uint32_t>(scal[2 * B + f]);

  const size_t plane = static_cast<size_t>(H) * W;
  const int32_t* s = src + (bcast ? 0 : plane * f);
  int32_t* o = out + plane * f;
  const int cl = col > 0 ? col - 1 : col;
  const int cr = col < W - 1 ? col + 1 : col;
  const int row_end = min(row0 + kChainRows, H);

  int i_c = index_of(s[static_cast<size_t>(row0) * W + col], li);
  for (int r = row0; r < row_end; ++r) {
    const int32_t* line = s + static_cast<size_t>(r) * W;
    const int rd = r < H - 1 ? r + 1 : r;
    const int i_d = index_of(s[static_cast<size_t>(rd) * W + col], li);
    const int i_r = index_of(line[cr], li);
    const int i_l = index_of(line[cl], li);

    int oi = i_c, ok = s_rank[i_c], nk;
    nk = s_rank[i_d];
    if (erode ? nk < ok : nk > ok) { oi = i_d; ok = nk; }
    nk = s_rank[i_r];
    if (erode ? nk < ok : nk > ok) { oi = i_r; ok = nk; }
    nk = s_rank[i_l];
    if (erode ? nk < ok : nk > ok) { oi = i_l; ok = nk; }

    uint32_t word = static_cast<uint32_t>(s_word[oi]);
    const int y = (word >> 8) & 255u;
    // gstzebrastripe.c:205-253: ((col + row + t) & 4) && Y >= thr -> Y = 16
    const bool stripe = ((static_cast<uint32_t>(col) +
                          static_cast<uint32_t>(r) + phase) & 4u) != 0;
    if (stripe && y >= thr) word = (word & 0xFFFF00FFu) | (16u << 8);
    o[static_cast<size_t>(r) * W + col] = static_cast<int32_t>(word);
    i_c = i_d;
  }
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
  const dim3 grid((W + kChainThreads - 1) / kChainThreads,
                  (H + kChainRows - 1) / kChainRows, B);
  const LinearIndex li{w0, w1, w2, w3, pre, post};
  dilate_zebra_kernel<<<grid, kChainThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
      static_cast<const int32_t*>(rank_table),
      static_cast<const int32_t*>(word_table),
      static_cast<const int32_t*>(scal), B, H, W, bcast, li);
  return static_cast<int>(cudaGetLastError());
}
