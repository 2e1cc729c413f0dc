// Dense-IoU ground-truth assignment reductions for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tinyfaces_tpu/ops/pallas_assignment.py
// (_block_kernel, called through dense_assignment_reductions). For every
// anchor (y, x, t) of a (Y, X, T) grid, centred at of + i * st, and every
// padded GT box g it computes the IoU with the MATLAB +1 convention, adds
// 1e-6 * U[0, 1) tie-break noise, masks invalid GTs to -1, and folds the
// value into two reductions without ever storing the (Y, X, T, G) tensor:
//
//   per anchor: max and first-index argmax over G  -> (B, Y, X, T)
//   per GT:     max over all anchors, argmax as a flat C-order index over
//               (Y, X, T), smallest index on ties  -> (B, G)
//
// What bounds it: arithmetic. Each (anchor, GT) pair costs ~20 flops and one
// IEEE division; the only device-memory traffic is the (B, Y, X, T) outputs.
// Design: one thread per anchor loops over the image's GT boxes, which sit
// in shared memory (G <= 512 -> 10 KB), with a strict '>' so the first GT
// wins per anchor. The per-GT reduction across the grid is a cross-block
// one: each warp reduces (orderable value, lowest lane) with redux.sync and
// a ballot, one lane folds a packed 64-bit key into a shared per-GT slot,
// and each block folds its slots into global memory with a 64-bit atomicMax
// on (orderable(value) << 32) | (0xFFFFFFFF - flat_index). Max is order
// independent, so the result is deterministic whatever the launch order.
//
// Noise: stateless Philox-4x32-10 keyed by the image's seed, counter
// (anchor, g / 4), one 32-bit draw per (anchor, g). Independent of the launch
// configuration. Build without fast math and with --fmad=false so the IoU
// rounds exactly like the plain PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 512;

__device__ __forceinline__ uint32_t orderable(float v) {
  uint32_t bits = __float_as_uint(v);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t o) {
  uint32_t bits = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(bits);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

__device__ __forceinline__ uint32_t pick(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float* __restrict__ gt_boxes,     // (B, G, 4)
    const uint8_t* __restrict__ gt_valid,   // (B, G)
    const float* __restrict__ templates,    // (T, 4)
    const int32_t* __restrict__ seeds,      // (B,)
    int G, int T, int X, int n_anchors,
    float ofx, float ofy, float stx, float sty, int noise,
    float* __restrict__ best_iou,           // (B, Y*X*T)
    int32_t* __restrict__ best_gt,          // (B, Y*X*T)
    unsigned long long* __restrict__ pgt_key) {  // (B, G), zero-initialised
  __shared__ float s_gx1[kMaxG], s_gy1[kMaxG], s_gx2[kMaxG], s_gy2[kMaxG];
  __shared__ float s_garea[kMaxG];
  __shared__ uint8_t s_valid[kMaxG];
  __shared__ unsigned long long s_key[kMaxG];

  const int b = blockIdx.y;
  const float* gb = gt_boxes + (size_t)b * G * 4;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float gx1 = gb[g * 4 + 0], gy1 = gb[g * 4 + 1];
    float gx2 = gb[g * 4 + 2], gy2 = gb[g * 4 + 3];
    s_gx1[g] = gx1; s_gy1[g] = gy1; s_gx2[g] = gx2; s_gy2[g] = gy2;
    s_garea[g] = (gx2 - gx1 + 1.0f) * (gy2 - gy1 + 1.0f);
    s_valid[g] = gt_valid[(size_t)b * G + g];
    s_key[g] = 0ull;
  }
  __syncthreads();

  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = a < n_anchors;
  const int aa = active ? a : 0;
  const int t = aa % T;
  const int x = (aa / T) % X;
  const int y = aa / (T * X);
  const float dx1 = templates[t * 4 + 0], dy1 = templates[t * 4 + 1];
  const float dx2 = templates[t * 4 + 2], dy2 = templates[t * 4 + 3];
  const float cx = ofx + (float)x * stx;
  const float cy = ofy + (float)y * sty;
  const float ax1 = cx + dx1, ay1 = cy + dy1, ax2 = cx + dx2, ay2 = cy + dy2;
  const float tarea = (dx2 - dx1 + 1.0f) * (dy2 - dy1 + 1.0f);
  const uint2 key = make_uint2((uint32_t)seeds[b], 0x7F4A7C15u);
  const int lane = threadIdx.x & 31;
  const uint32_t warp_first = (uint32_t)(a - lane);

  float best_v = __uint_as_float(0xFF800000u);  // -inf
  int best_g = 0;
  uint4 bits = make_uint4(0, 0, 0, 0);
  for (int g = 0; g < G; ++g) {
    float iw = fminf(ax2, s_gx2[g]) - fmaxf(ax1, s_gx1[g]) + 1.0f;
    float ih = fminf(ay2, s_gy2[g]) - fmaxf(ay1, s_gy1[g]) + 1.0f;
    float inter = iw * ih;
    float v = (iw > 0.0f && ih > 0.0f) ? inter / (tarea + s_garea[g] - inter) : 0.0f;
    if (noise) {
      if ((g & 3) == 0) bits = philox4x32_10(make_uint4((uint32_t)aa, (uint32_t)(g >> 2), 0u, 0u), key);
      v = v + 1e-6f * ((float)(pick(bits, g & 3) >> 8) * (1.0f / 16777216.0f));
    }
    if (!s_valid[g]) v = -1.0f;
    if (v > best_v) { best_v = v; best_g = g; }

    // Per-GT: warp max of the orderable value, lowest lane (= lowest flat
    // index) among the lanes holding it; inactive lanes hold 0.
    uint32_t o = active ? orderable(v) : 0u;
    uint32_t m = __reduce_max_sync(0xFFFFFFFFu, o);
    uint32_t hit = __ballot_sync(0xFFFFFFFFu, o == m);
    if (lane == 0 && m != 0u) {
      uint32_t idx = warp_first + (uint32_t)(__ffs(hit) - 1);
      atomicMax(&s_key[g], ((unsigned long long)m << 32) | (0xFFFFFFFFu - idx));
    }
  }
  if (active) {
    best_iou[(size_t)b * n_anchors + a] = best_v;
    best_gt[(size_t)b * n_anchors + a] = best_g;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (s_key[g] != 0ull) atomicMax(&pgt_key[(size_t)b * G + g], s_key[g]);
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ pgt_key, int n,
                              float* __restrict__ pgt_max, int32_t* __restrict__ pgt_idx) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long k = pgt_key[i];
  pgt_max[i] = from_orderable((uint32_t)(k >> 32));
  pgt_idx[i] = (int32_t)(0xFFFFFFFFu - (uint32_t)(k & 0xFFFFFFFFull));
}

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise, allocates nothing: pgt_key must be zeroed by the caller.
extern "C" int tf_dense_assignment(
    const float* gt_boxes, const uint8_t* gt_valid, const float* templates,
    const int32_t* seeds, int B, int G, int T, int Y, int X,
    float ofx, float ofy, float stx, float sty, int noise,
    float* best_iou, int32_t* best_gt, float* pgt_max, int32_t* pgt_idx,
    unsigned long long* pgt_key, void* stream) {
  if (G < 1 || G > kMaxG || T < 1 || B < 1 || Y < 1 || X < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_anchors = Y * X * T;
  dim3 grid((n_anchors + kThreads - 1) / kThreads, B);
  reduce_kernel<<<grid, kThreads, 0, s>>>(
      gt_boxes, gt_valid, templates, seeds, G, T, X, n_anchors,
      ofx, ofy, stx, sty, noise, best_iou, best_gt, pgt_key);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * G;
  unpack_kernel<<<(n + 255) / 256, 256, 0, s>>>(pgt_key, n, pgt_max, pgt_idx);
  return (int)cudaGetLastError();
}
