// Exact greedy non-maximum suppression for Hopper (sm_90a): kernel N1.
//
// The port's counterpart of the device loops of the JAX package's NMS
// (tinyfaces_tpu/ops/nms.py: the fixpoint lax.while_loop at :42 and the
// blocked lax.while_loop at :119). It has no Pallas ancestor. Like them it
// keeps the whole suppression on the device: the valid extent of each image
// is read here and never returned to the host, so the pyramid that calls it
// can be captured into one CUDA graph.
//
// Contract (ops/nms_kernel.py): rank-sorted boxes (B, N, 4) fp32, a
// validity mask (B, N) bool in rank order and the IoU threshold -> the
// greedy keep mask (B, N) bool in rank order. Row i is kept iff it is
// valid and no kept row ranked above it has IoU > threshold with it;
// invalid rows are never kept and suppress nothing. That keep set is also
// the Jacobi fixpoint's of ops/nms.py. The caller passes the workspace: the
// (B, N, W) uint64 suppression mask, W = ceil(N / 64), and (B,) int32 for
// the extents. Nothing here allocates.
//
// Three launches on the caller's stream:
//   1. extent_kernel, one block per image: the valid extent n_b, one past
//      the last valid rank (the valid count whenever the valid rows rank
//      first, as ops/nms.py ranks them).
//   2. mask_kernel, one 64-thread block per (64-column tile, 64-row tile,
//      image) with column tile >= row tile. The block stages its 64 column
//      boxes in shared memory; thread t owns row i and writes one word:
//      bit j set where column c = 64 * tile + j is ranked below i and
//      IoU(i, c) > threshold. Tiles wholly past n_b return at once.
//   3. scan_kernel, one 64-thread block per image. The suppressed set lives
//      in shared memory (W words, 63 at N = 4000). It walks the ranked rows
//      up to n_b in 64-row chunks: the chunk's 64 diagonal words are
//      loaded in parallel, thread 0 resolves the chunk serially in
//      registers (kept = valid and not suppressed; a kept row ORs its
//      word into the running set), then every thread ORs the kept rows'
//      words into one later chunk's suppressed word, 8 loads in flight.
//
// What bounds it on an H100: at the main path's shapes (N = 4000, B up to
// 32) the IoU arithmetic of the n_b (n_b - 1) / 2 valid pairs, 14 fp32
// operations a pair, against 67 TFLOP/s, and the mask's bytes (written
// once, read once) against 3.35 TB/s; the scan adds a chain of n_b
// dependent steps per image. ops/nms_kernel.nms_bound counts them.
//
// Build without fast math and with --fmad=false, so the IoU rounds exactly
// as ops/boxes.pairwise_iou does: inter / (area_i + area_j - inter), the
// intersection clamped at 0, 0 where the union is <= 0, a strict > the
// threshold. max, min and the clamp propagate NaN as torch.maximum,
// torch.minimum and clamp_min do. Every comparison is then bit-equal to
// the plain version's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;  // rows and columns of a mask tile, bits of a word
constexpr int kMaxN = 65536;  // the scan's shared suppressed set: 2 * 1024 words

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float clamp0(float d) { return d < 0.0f ? 0.0f : d; }  // NaN stays

struct Box {
  float x1, y1, x2, y2, area;
};

__device__ __forceinline__ Box load_box(const float* p) {
  Box b{p[0], p[1], p[2], p[3], 0.0f};
  b.area = __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
  return b;
}

// IoU(a, b) > thr with a the higher-ranked (row) box, in pairwise_iou's order.
__device__ __forceinline__ bool overlaps(const Box& a, const Box& b, float thr) {
  const float x1 = max_nan(a.x1, b.x1);
  const float y1 = max_nan(a.y1, b.y1);
  const float x2 = min_nan(a.x2, b.x2);
  const float y2 = min_nan(a.y2, b.y2);
  const float inter = __fmul_rn(clamp0(__fsub_rn(x2, x1)), clamp0(__fsub_rn(y2, y1)));
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__global__ void extent_kernel(const uint8_t* __restrict__ valid, int N, int32_t* __restrict__ extent) {
  __shared__ int last;
  if (threadIdx.x == 0) last = -1;
  __syncthreads();
  const uint8_t* v = valid + (size_t)blockIdx.x * N;
  int mine = -1;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    if (v[i]) mine = i;
  if (mine >= 0) atomicMax(&last, mine);
  __syncthreads();
  if (threadIdx.x == 0) extent[blockIdx.x] = last + 1;
}

__global__ void __launch_bounds__(kTile) mask_kernel(
    const float* __restrict__ boxes, const int32_t* __restrict__ extent, int N, int W, float thr,
    unsigned long long* __restrict__ mask) {
  const int cw = blockIdx.x, rw = blockIdx.y, b = blockIdx.z;
  const int nv = extent[b];
  // Uniform over the block: lower triangle, or rows or columns past n_b.
  if (cw < rw || rw * kTile >= nv || cw * kTile >= nv) return;
  __shared__ Box cols[kTile];
  const int t = threadIdx.x;
  const float* img = boxes + (size_t)b * N * 4;
  const int c = cw * kTile + t;
  if (c < nv) cols[t] = load_box(img + (size_t)c * 4);
  __syncthreads();
  const int i = rw * kTile + t;
  if (i >= nv) return;
  const Box a = load_box(img + (size_t)i * 4);
  const int jend = min(kTile, nv - cw * kTile);
  unsigned long long bits = 0ull;
  for (int j = (cw == rw) ? t + 1 : 0; j < jend; ++j)
    if (overlaps(a, cols[j], thr)) bits |= 1ull << j;
  mask[((size_t)b * N + i) * W + cw] = bits;
}

__global__ void __launch_bounds__(kTile) scan_kernel(
    const uint8_t* __restrict__ valid, const unsigned long long* __restrict__ mask,
    const int32_t* __restrict__ extent, int N, int W, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long words[];  // sup[W], then kept[W]
  unsigned long long* sup = words;
  unsigned long long* kept = words + W;
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned int vbits[2];
  __shared__ int rows[kTile];
  __shared__ int n_rows;
  const int b = blockIdx.x, t = threadIdx.x;
  const int nv = extent[b];
  const int chunks = (nv + kTile - 1) / kTile;
  const unsigned long long* img = mask + (size_t)b * N * W;
  const uint8_t* v = valid + (size_t)b * N;
  for (int w = t; w < W; w += kTile) sup[w] = kept[w] = 0ull;
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const int i = c * kTile + t;
    diag[t] = i < nv ? img[(size_t)i * W + c] : 0ull;
    const unsigned int ballot = __ballot_sync(0xffffffffu, i < nv && v[i]);
    if ((t & 31) == 0) vbits[t >> 5] = ballot;
    __syncthreads();
    if (t == 0) {
      const unsigned long long vb = (unsigned long long)vbits[0] | ((unsigned long long)vbits[1] << 32);
      unsigned long long s = sup[c], k = 0ull;
      int n = 0;
      for (int j = 0; j < kTile; ++j) {
        if (((vb & ~s) >> j) & 1ull) {
          k |= 1ull << j;
          s |= diag[j];  // only bits above j: rows ranked below
          rows[n++] = c * kTile + j;
        }
      }
      kept[c] = k;
      n_rows = n;
    }
    __syncthreads();
    const int n = n_rows;
    for (int w = c + 1 + t; w < chunks; w += kTile) {
      unsigned long long acc[8] = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
      for (int q = 0; q < n; q += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (q + u < n) acc[u] |= img[(size_t)rows[q + u] * W + w];
      }
      sup[w] |= acc[0] | acc[1] | acc[2] | acc[3] | acc[4] | acc[5] | acc[6] | acc[7];
    }
    __syncthreads();
  }
  for (int i = t; i < N; i += kTile) keep[(size_t)b * N + i] = (uint8_t)((kept[i / kTile] >> (i % kTile)) & 1ull);
}

}  // namespace

extern "C" int tf_nms_keep(const float* boxes, const uint8_t* valid, int B, int N, float thr,
                           unsigned long long* mask, int32_t* extent, uint8_t* keep, void* stream) {
  if (B < 1 || N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int W = (N + kTile - 1) / kTile;
  extent_kernel<<<B, 256, 0, s>>>(valid, N, extent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mask_kernel<<<dim3(W, W, B), kTile, 0, s>>>(boxes, extent, N, W, thr, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<B, kTile, 2 * W * sizeof(unsigned long long), s>>>(valid, mask, extent, N, W, keep);
  return (int)cudaGetLastError();
}
