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
// What bounds it on an H100: instruction issue. The only device-memory
// traffic is the GT list in and the (B, Y, X, T) maps out (~9.5 MB at the
// train step's shapes, ~3 us at 3.35 TB/s); everything else is per-pair
// arithmetic on operands in registers and shared memory. The bound counts
// ~15 fp32 operations per *valid* (anchor, GT) pair at 67 TFLOP/s. The
// compiled loop (sm_90a SASS, noise on) issues 199 instructions per valid
// GT for a thread's 4 anchors, ~50 per pair:
//   - the IoU: 4 min/max/add for the width, 1 mul, 1 sub, 1 compare; the
//     height, the area sum and the GT's two shared loads are per thread;
//   - the IEEE division (div.rn.f32): 15 with its branches: MUFU.RCP,
//     FCHK, five FFMA (Newton steps and the remainder correction) and a
//     call to a slow path that these operands never take. The compiler
//     branches around it where no lane of the warp overlaps the GT, which
//     saves most of them: dividing on every pair was much slower. It
//     cannot be cross-multiplied away: the noise is added to the quotient,
//     and the result must round like the plain PyTorch version;
//   - the noise: 13, fmix32 (2 IMAD, 3 shift/xor pairs) on a key built with
//     one IMAD, the shift to 24 bits, I2FP, one multiply and the add;
//   - the reductions: 6 compare/selects, plus per GT two REDUX, a packed
//     store by lane 0 and the loop's bookkeeping.
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700.00 W,
// device time of a CUDA-graph replay): 0.18 ms for 106 M valid pairs at
// the G192 scene, 7.6x its 0.024 ms bound; the earlier one-thread-per-
// anchor kernel took 0.89 ms on the same inputs. At 50 instructions per
// pair, 4 schedulers x 132 SMs at ~1.75 GHz issue 106 M pairs in ~0.18 ms:
// issue-bound.
//
// The design, point by point:
//   1. Compaction. Each block lists its image's valid g in shared memory,
//      in their original order (a ballot and a prefix sum over the warps),
//      and loops over n_valid only. Exact: a valid value is >= 0 and an
//      invalid one -1, so padding never wins; an image without valid GT
//      gives (-1, 0) per anchor, and an invalid g (-1, 0), which
//      unpack_kernel writes for every g that no block touched: the plain
//      version's first-index result.
//   2. Shared-memory traffic. A GT costs one broadcast 128-bit load (its
//      box) and one 64-bit load (area, original index). Each thread owns
//      kAnchors anchors along x at one (y, t): they share the template,
//      the GT's intersection height and the area sum, so one pair of loads
//      serves kAnchors pairs.
//   3. Noise. A counter hash keyed by (image seed, flat anchor index,
//      original g): fmix32(fmix32(fmix32(seed ^ C0) ^ a) + g * C1) >> 8,
//      24 random bits, times 1e-6 * 2^-24. Independent of the launch
//      configuration; `kernel_noise` in ops/assignment_kernel.py mirrors it
//      bit for bit, so the plain version fed those draws must agree with
//      the kernel at the value level with noise on.
//   4. Per-GT reduction without atomics in the loop. For each g a thread
//      reduces over its own anchors in registers, the warp with two
//      redux.sync (max value, then the lowest flat index holding it), and
//      lane 0 stores the warp's packed key to s_part[warp][k] with a plain
//      store. After the loop one pass folds the warps and issues one global
//      64-bit atomicMax per valid g per block, on the key
//      (orderable(value) << 32) | ~flat_index. Max does not depend on
//      order, so the result is deterministic. Global atomics, not a
//      cluster exchange through distributed shared memory: at the train
//      step's shapes they are ~100 per valid g per image, a few thousand
//      per image against ~10^7 pairs, and leave the loop untouched.
//   5. Longest work first. A block's time grows with its image's n_valid,
//      and a training batch mixes a crowd crop (up to G valid) with crops
//      of a few faces. Each block counts every image's valid GTs (B * G
//      bytes, from L2) and the launch walks the images heaviest first, so
//      the long blocks start in the first wave instead of ending the launch.
//
// Build without fast math and with --fmad=false, so the IoU rounds exactly
// like the plain PyTorch version: with noise off the two agree bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAnchors = 4;  // anchors per thread, neighbours along x
constexpr int kMaxG = 512;
constexpr uint32_t kFull = 0xFFFFFFFFu;
// 1e-6 * 2^-24: the noise is 1e-6 * (24-bit draw * 2^-24), and scaling by a
// power of two commutes with rounding, so one multiply gives the same bits.
constexpr float kNoiseUnit = 1e-6f * 0x1p-24f;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kNoise>
__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float4* __restrict__ gt_boxes,    // (B, G) boxes x1, y1, x2, y2
    const uint8_t* __restrict__ gt_valid,   // (B, G)
    const float* __restrict__ templates,    // (T, 4)
    const int32_t* __restrict__ seeds,      // (B,)
    int B, int G, int T, int Y, int X, int XQ, int tiles,
    float ofx, float ofy, float stx, float sty,
    float* __restrict__ best_iou,           // (B, Y*X*T)
    int32_t* __restrict__ best_gt,          // (B, Y*X*T)
    unsigned long long* __restrict__ pgt_key) {  // (B, G), zero-initialised
  // Dynamic shared memory, (88 * G + 8 * B) bytes at 8 warps: boxes, per-warp partial
  // keys, (area bits, original g) of the compacted valid GTs; every image's
  // valid count, the images in launch order.
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  unsigned long long* s_part = reinterpret_cast<unsigned long long*>(smem + 16 * G);
  uint2* s_aux = reinterpret_cast<uint2*>(smem + 16 * G + 8 * kWarps * G);
  int* s_nv = reinterpret_cast<int*>(smem + (16 + 8 * kWarps + 8) * G);
  int* s_img = s_nv + B;
  __shared__ int s_count[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // 0. Longest work first: count every image's valid GTs and order the
  // images by count, descending (stable); block i works on tile i % tiles
  // of the (i / tiles)-th image in that order, so the crowded images'
  // blocks are dispatched first and the light ones fill in behind them.
  for (int bi = warp; bi < B; bi += kWarps) {
    int n = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      n += __popc(__ballot_sync(kFull, g < G && gt_valid[(size_t)bi * G + g]));
    }
    if (lane == 0) s_nv[bi] = n;
  }
  __syncthreads();
  for (int bi = threadIdx.x; bi < B; bi += kThreads) {
    const int n = s_nv[bi];
    int rank = 0;
    for (int o = 0; o < B; ++o) rank += s_nv[o] > n || (s_nv[o] == n && o < bi);
    s_img[rank] = bi;
  }
  __syncthreads();
  const int b = s_img[blockIdx.x / tiles];
  const int tile = blockIdx.x % tiles;

  // 1. Compact the image's valid GTs, keeping their order.
  int n_valid = 0;
  for (int g0 = 0; g0 < G; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    const bool valid = g < G && gt_valid[(size_t)b * G + g];
    const uint32_t ballot = __ballot_sync(kFull, valid);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = n_valid, total = n_valid;
    for (int w = 0; w < kWarps; ++w) {
      offset += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (valid) {
      const int k = offset + __popc(ballot & ((1u << lane) - 1u));
      const float4 box = gt_boxes[(size_t)b * G + g];
      s_box[k] = box;
      s_aux[k] = make_uint2(__float_as_uint((box.z - box.x + 1.0f) * (box.w - box.y + 1.0f)),
                            (uint32_t)g);
    }
    __syncthreads();
    n_valid = total;
  }

  // 2. This thread's anchors (y, xq * kAnchors + j, t). A thread past the
  // last item, and a column past the grid's edge, shadows a live anchor:
  // same coordinates, same flat index, so it changes no reduction.
  const int items = Y * XQ * T;
  const int item = tile * kThreads + threadIdx.x;
  const bool live = item < items;
  const int w = live ? item : items - 1;
  const int t = w % T;
  const int xq = (w / T) % XQ;
  const int y = w / (T * XQ);
  const float dx1 = templates[t * 4 + 0], dy1 = templates[t * 4 + 1];
  const float dx2 = templates[t * 4 + 2], dy2 = templates[t * 4 + 3];
  const float cy = ofy + (float)y * sty;
  const float ay1 = cy + dy1, ay2 = cy + dy2;
  const float tarea = (dx2 - dx1 + 1.0f) * (dy2 - dy1 + 1.0f);
  const uint32_t seed_key = fmix32((uint32_t)seeds[b] ^ 0x7F4A7C15u);

  float ax1[kAnchors], ax2[kAnchors], best_v[kAnchors];
  uint32_t flat[kAnchors], akey[kAnchors];
  int best_g[kAnchors];
#pragma unroll
  for (int j = 0; j < kAnchors; ++j) {
    int x = xq * kAnchors + j;
    x = x < X ? x : xq * kAnchors;
    const float cx = ofx + (float)x * stx;
    ax1[j] = cx + dx1;
    ax2[j] = cx + dx2;
    flat[j] = (uint32_t)((y * X + x) * T + t);
    akey[j] = fmix32(seed_key ^ flat[j]);
    best_v[j] = -1.0f;
    best_g[j] = 0;
  }

  for (int k = 0; k < n_valid; ++k) {
    const float4 gb = s_box[k];
    const uint2 aux = s_aux[k];
    const float area_sum = tarea + __uint_as_float(aux.x);
    const float ih = fminf(ay2, gb.w) - fmaxf(ay1, gb.y) + 1.0f;
    const uint32_t gkey = aux.y * 0x9E3779B9u;
    uint32_t part_v = 0, part_i = 0;
#pragma unroll
    for (int j = 0; j < kAnchors; ++j) {
      const float iw = fminf(ax2[j], gb.z) - fmaxf(ax1[j], gb.x) + 1.0f;
      const float inter = iw * ih;
      float v = (iw > 0.0f && ih > 0.0f) ? inter / (area_sum - inter) : 0.0f;
      if (kNoise) v = v + (float)(fmix32(akey[j] + gkey) >> 8) * kNoiseUnit;
      if (v > best_v[j]) {
        best_v[j] = v;
        best_g[j] = (int)aux.y;
      }
      // v >= 0, so its bits order like its value; ascending j is ascending
      // flat index, so a strict '>' keeps the first.
      const uint32_t o = __float_as_uint(v);
      if (j == 0 || o > part_v) {
        part_v = o;
        part_i = flat[j];
      }
    }
    const uint32_t m = __reduce_max_sync(kFull, part_v);
    const uint32_t i = __reduce_min_sync(kFull, part_v == m ? part_i : kFull);
    if (lane == 0)
      s_part[warp * G + k] = ((unsigned long long)(m | 0x80000000u) << 32) | (uint32_t)~i;
  }

  if (live) {
    const size_t base = (size_t)b * Y * X * T;
#pragma unroll
    for (int j = 0; j < kAnchors; ++j) {
      if (xq * kAnchors + j < X) {
        best_iou[base + flat[j]] = best_v[j];
        best_gt[base + flat[j]] = best_g[j];
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_valid; k += kThreads) {
    unsigned long long key = s_part[k];
    for (int w2 = 1; w2 < kWarps; ++w2) {
      const unsigned long long other = s_part[w2 * G + k];
      key = other > key ? other : key;
    }
    atomicMax(&pgt_key[(size_t)b * G + s_aux[k].y], key);
  }
}

// Keys to (max, index); a g no block touched is invalid: (-1, 0).
__global__ void unpack_kernel(const unsigned long long* __restrict__ pgt_key, int n,
                              float* __restrict__ pgt_max, int32_t* __restrict__ pgt_idx) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long k = pgt_key[i];
  pgt_max[i] = k ? __uint_as_float((uint32_t)(k >> 32) & 0x7FFFFFFFu) : -1.0f;
  pgt_idx[i] = k ? (int32_t)~(uint32_t)k : 0;
}

}  // namespace

// Returns a cudaError_t (0 on success). Launches on `stream`, does not
// synchronise, allocates nothing: pgt_key must be zeroed by the caller and
// gt_boxes 16-byte aligned.
extern "C" int tf_dense_assignment(
    const float* gt_boxes, const uint8_t* gt_valid, const float* templates,
    const int32_t* seeds, int B, int G, int T, int Y, int X,
    float ofx, float ofy, float stx, float sty, int noise,
    float* best_iou, int32_t* best_gt, float* pgt_max, int32_t* pgt_idx,
    unsigned long long* pgt_key, void* stream) {
  if (G < 1 || G > kMaxG || T < 1 || B < 1 || Y < 1 || X < 1 ||
      reinterpret_cast<uintptr_t>(gt_boxes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int xq = (X + kAnchors - 1) / kAnchors;
  const int tiles = (Y * xq * T + kThreads - 1) / kThreads;
  const size_t smem = (size_t)G * (16 + 8 * kWarps + 8) + (size_t)B * 8;
  const float4* boxes = reinterpret_cast<const float4*>(gt_boxes);
  auto kernel = noise ? reduce_kernel<true> : reduce_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<tiles * B, kThreads, smem, s>>>(boxes, gt_valid, templates, seeds, B, G, T, Y, X, xq,
                                           tiles, ofx, ofy, stx, sty, best_iou, best_gt, pgt_key);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * G;
  unpack_kernel<<<(n + 255) / 256, 256, 0, s>>>(pgt_key, n, pgt_max, pgt_idx);
  return (int)cudaGetLastError();
}
