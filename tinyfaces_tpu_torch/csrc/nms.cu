// Exact greedy non-maximum suppression for Hopper (sm_90a): kernel N1.
//
// The port's counterpart of the device loops of the JAX package's NMS
// (tinyfaces_tpu/ops/nms.py: the fixpoint lax.while_loop at :42 and the
// blocked lax.while_loop at :119). It has no Pallas ancestor. It runs the
// JAX blocked scheme at 64 rows a block: resolve a block of ranked rows
// exactly, then let only that block's kept rows suppress the rows ranked
// below it. The whole suppression stays on the device and nothing is read
// back to the host, so the pyramid that calls it is captured into one CUDA
// graph.
//
// Contract (ops/nms_kernel.py): rank-sorted boxes (B, N, 4) fp32, a
// validity mask (B, N) bool in rank order and the IoU threshold -> the
// greedy keep mask (B, N) bool in rank order. Row i is kept iff it is
// valid and no kept row ranked above it has IoU > threshold with it;
// invalid rows are never kept and suppress nothing. That keep set is also
// the Jacobi fixpoint's of ops/nms.py. No workspace: the kernel writes only
// the keep mask.
//
// One launch. Each image gets a thread-block cluster of cs blocks (8 blocks
// of 1024 threads up to B = 8, 4 up to 16, 4 of 512 up to 32: launch_shape,
// so that the clusters run in one wave), everything else in shared memory:
//   * in every block, the image's first n_b boxes, 16 B a row (64 KB at N =
//     4000), staged with coalesced 16-byte loads, n_b being the valid
//     extent (one past the last valid rank); rows past what fits (about
//     12,000 at N = 16,000 in the 227 KB a block may have) are read from
//     device memory;
//   * in the leader (rank 0), a "dead" bitset of N bits (500 B at N =
//     4000): a row is dead when it is invalid, suppressed, or resolved and
//     not kept. It starts as the invalid rows, one ballot per 32 rows;
//   * in each other block (the leader's other warps when cs = 1), per warp a
//     list of its live rows (2 B a row) from a share of the bitset words,
//     compacted in place by the warp alone: no atomics, no barrier.
// Then one step for each 64-row chunk c up to n_b, ended by one barrier over
// the cluster (a block barrier when cs = 1):
//   * the leader's warp 0 resolves chunk c from its diagonal words as the
//     Jacobi fixpoint, kept = live & ~OR(words of kept rows), one
//     OR-reduction over the warp a round, as many rounds as the chunk's
//     longest suppression chain (not 64 steps), and stores the kept rows'
//     boxes in every block of the cluster (distributed shared memory), in
//     one of two buffers;
//   * then the leader tests chunk c + 1's rows against chunk c's kept rows,
//     every (row, kept row) pair spread over its threads, and computes
//     chunk c + 1's diagonal: a live row a warp, two ballots of its 64
//     overlap bits;
//   * meanwhile the other blocks suppress the rows further below with chunk
//     c - 1's kept rows: each warp tests its listed rows against every one,
//     sets the leader's dead bits of the rows hit (atomicOr into its shared
//     memory), and keeps the rest listed.
// So chunk c + 1 has been tested against every kept row above it before it
// is resolved, and the bulk of the tests runs beside the chain, on other
// SMs. The IoU tests are the pairs under a kept row whose lower row is
// still alive, plus the live pairs of each chunk's diagonal; no pair is
// tested twice, and no suppression matrix leaves shared memory. The keep
// mask is written once at the end: not dead.
//
// What bounds it on an H100: the greedy chain, one step a chunk (the
// resolve, the next chunk's tests and diagonal, a cluster barrier), and
// where most rows are kept (the seeded, uncalibrated weights of the
// instruments keep about 3,650 of 4,000) the tests, nearly every pair:
// those run on cs - 1 SMs an image. The tests issue most of the
// instructions (about 25 a test), so they run branch-free: the lanes of a
// warp never part, and the division is replaced by an exact fp64
// comparison. ops/nms_kernel.nms_bound counts the function's bound (the
// IoU operations under a kept row, the bytes in and out) and this
// design's chain.
//
// Build without fast math and with --fmad=false, so the IoU rounds exactly
// as ops/boxes.pairwise_iou does: inter / (area_a + area_b - inter) with
// the higher-ranked box as a, the intersection clamped at 0, 0 where the
// union is <= 0, a strict > the threshold. max and min propagate NaN as
// torch.maximum and torch.minimum do. Every comparison is then bit-equal
// to the plain version's, and the greedy keep set does not depend on the
// order in which pairs are tested or on the cluster size.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;  // rows resolved together, bits of a chunk word
constexpr int kMaxN = 65536;  // the live rows' lists hold 16-bit row numbers
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating max and min (PTX .NaN, sm_80+), as torch.maximum and
// torch.minimum.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The threshold as the tests use it. fp32 division rounds to nearest even,
// so RN(q) > thr exactly when q > mid, the midpoint between thr and the
// next float up, or q == mid and that tie rounds up (the next float's last
// bit is even). For q = inter / uni with uni > 0 that is inter > mid * uni
// (or ==), and in fp64 the product of mid (25 significant bits) and uni
// (24) is exact: the comparison gives the bit that __fdiv_rn(inter, uni) >
// thr gives, with no division and no branch. Past the largest float the
// next one is the overflow to infinity at 2^128.
struct Threshold {
  double mid;
  bool tie_up, zero_hits;  // zero_hits: an IoU of 0 is > thr
};

__device__ __forceinline__ Threshold threshold_of(float thr) {
  const float up = nextafterf(thr, INFINITY);
  const bool top = isinf(up) && !isinf(thr);
  Threshold t;
  t.mid = top ? (double)thr + 0x1p103 : 0.5 * ((double)thr + (double)up);
  t.tie_up = top || (__float_as_uint(up) & 1u) == 0u;
  t.zero_hits = 0.0f > thr;
  return t;
}

// IoU(a, b) > thr for active lanes, a the higher-ranked box, in
// pairwise_iou's order: inter = clamp0(x2 - x1) * clamp0(y2 - y1), iou =
// inter / (area_a + area_b - inter) where that union is > 0, else 0. Where
// a side x2 - x1 or y2 - y1 is not > 0 (<= 0 or NaN) the intersection is 0
// or NaN and the IoU 0, so the answer is 0 > thr; past it the clamps are
// the identity. Straight-line code: the lanes of a warp never part.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         const Threshold& t, bool active) {
  const float dx = __fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x));
  const float dy = __fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y));
  const float inter = __fmul_rn(dx, dy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const bool pos = active && dx > 0.0f && dy > 0.0f && uni > 0.0f;
  const double p = t.mid * (double)uni, q = (double)inter;
  const bool above = q > p || (t.tie_up && q == p);
  return active && (pos ? above : t.zero_hits);
}

// Shared memory beside the staged boxes: two buffers of up to 64 kept
// boxes (16 B) and areas (4 B), the diagonal's 64 words of 8 B, four ints,
// the bitset's 2 C words (C = ceil(N / 64)) and the warps' lists of live
// rows, 2 B a row: a warp's list has room for the rows of its bitset words,
// at most every (warps - 1)-th word.
__host__ __device__ constexpr int list_room(int n, int warps) {
  return 32 * ((2 * ((n + kChunk - 1) / kChunk) + warps - 2) / (warps - 1));
}

__host__ __device__ constexpr size_t fixed_bytes(int n, int warps) {
  return (size_t)2 * kChunk * 20 + kChunk * 8 + 4 * 4 + (size_t)((n + kChunk - 1) / kChunk) * 8
         + (size_t)2 * warps * list_room(n, warps);
}

__device__ __forceinline__ float4 box_of(int i, const float4* sbox, const float4* img, int cap) {
  return i < cap ? sbox[i] : __ldg(img + i);
}

// The live rows of the chunk whose words start at dead[w], as lane 0 of
// the warp reads them. Other blocks of the cluster may be setting bits
// there meanwhile (bits only ever get set), so the warp takes one reading.
__device__ __forceinline__ uint64_t live_of(const uint32_t* dead, int w) {
  const volatile uint32_t* d = dead;
  return __shfl_sync(kFull, ~((uint64_t)d[w] | ((uint64_t)d[w + 1] << 32)), 0);
}

// The diagonal words of the chunk whose dead bits start at word 2 c, rows r
// = warp, warp + warps, ...: diag[r] (as two 32-bit halves) has bit j set
// where the rows r < j of the chunk, both alive in this warp's reading,
// overlap. A word is written only for a row alive in that reading: rows
// die and never revive, so every row still alive when the chunk is
// resolved has its word, over every row alive then.
__device__ __forceinline__ void diagonal(uint32_t* diag, const uint32_t* dead, int c, int warps,
                                         int warp, int lane, const Threshold& thr, const float4* sbox,
                                         const float4* img, int cap) {
  const uint64_t live = live_of(dead, 2 * c);
  const int c0 = c * kChunk;
  for (int r = warp; r < kChunk; r += warps) {
    if (!((live >> r) & 1ull)) continue;  // uniform over the warp
    const float4 a = box_of(c0 + r, sbox, img, cap);
    const float aa = area_of(a);
    const int j0 = lane, j1 = lane + 32;
    const bool on0 = j0 > r && ((live >> j0) & 1ull), on1 = j1 > r && ((live >> j1) & 1ull);
    const float4 b0 = on0 ? box_of(c0 + j0, sbox, img, cap) : a;
    const float4 b1 = on1 ? box_of(c0 + j1, sbox, img, cap) : a;
    const uint32_t lo = __ballot_sync(kFull, overlaps(a, aa, b0, area_of(b0), thr, on0));
    const uint32_t hi = __ballot_sync(kFull, overlaps(a, aa, b1, area_of(b1), thr, on1));
    if (lane == 0) {
      diag[2 * r] = lo;
      diag[2 * r + 1] = hi;
    }
  }
}

// A barrier over the image's blocks: the cluster's, with release and
// acquire, so that what each block wrote to another's shared memory is seen
// after it; a block barrier when the image has one block.
__device__ __forceinline__ void sync_cluster(int cs) {
  if (cs > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

__global__ void __launch_bounds__(1024) nms_keep_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int N, int cap, float iou_thr,
    uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);  // [cap]
  float4* kbox = sbox + cap;  // [2][64]: the kept boxes of even and odd chunks
  float* karea = reinterpret_cast<float*>(kbox + 2 * kChunk);  // [2][64]
  uint32_t* diag = reinterpret_cast<uint32_t*>(karea + 2 * kChunk);  // [64] words as 32-bit halves
  int* misc = reinterpret_cast<int*>(diag + 2 * kChunk);  // extent, kept counts [2]
  uint32_t* dead = reinterpret_cast<uint32_t*>(misc + 4);  // [2 C]
  const int words = 2 * ((N + kChunk - 1) / kChunk);

  // A cluster of cs blocks an image. The leader (rank 0) holds the image's
  // dead bitset, resolves the chunks and suppresses each chunk's next one;
  // the other blocks suppress the rows further below, a share of the bitset
  // words each, setting bits in the leader. With cs = 1 the leader's warps
  // but warp 0 do that.
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  const int workers = cs == 1 ? 1 : cs - 1, worker = cs == 1 ? 0 : rank - 1;
  uint32_t* lead_dead = leader ? dead : cluster.map_shared_rank(dead, 0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  // The warps that suppress below, and this one's place among them.
  const int fwarps = cs == 1 ? warps - 1 : warps, fwarp = cs == 1 ? warp - 1 : warp;
  const bool forwards = (cs == 1 || rank > 0) && fwarp >= 0;
  // This warp's list of live rows below the current chunk, in rank order.
  uint16_t* list = reinterpret_cast<uint16_t*>(dead + words) + warp * list_room(N, warps);
  const Threshold thr = threshold_of(iou_thr);
  const unsigned below = (1u << lane) - 1u;
  const size_t image = blockIdx.x / cs;
  const float4* img = boxes + image * N;
  const uint8_t* v = valid + image * N;

  if (t == 0) misc[0] = 0;
  __syncthreads();
  // The dead bitset starts as the invalid rows (and the rows past N); the
  // extent n_b is one past the last valid row.
  int last = 0;
#pragma unroll 4
  for (int w = warp; w < words; w += warps) {
    const int i = 32 * w + lane;
    const bool ok = i < N && v[i];
    if (ok) last = i + 1;
    const uint32_t bits = __ballot_sync(kFull, ok);
    if (lane == 0) dead[w] = ~bits;
  }
  last = (int)__reduce_max_sync(kFull, (unsigned)last);
  if (lane == 0 && last > 0) atomicMax(&misc[0], last);
  __syncthreads();
  const int nb = misc[0];
#pragma unroll 4
  for (int i = t; i < min(nb, cap); i += blockDim.x) sbox[i] = __ldg(img + i);
  // This warp's first list: the valid rows below chunk 1 of its bitset
  // words (the worker's words w, w + workers, ...; of those, the warp's
  // every fwarps-th).
  int count = 0;
  if (forwards) {
    for (int w = worker + workers * fwarp; w < (nb + 31) >> 5; w += workers * fwarps) {
      const uint32_t m = ~dead[w] & (w < 4 ? 0u : kFull);
      if ((m >> lane) & 1u) list[count + __popc(m & below)] = (uint16_t)(32 * w + lane);
      count += __popc(m);
    }
  }
  __syncthreads();
  const int chunks = (nb + kChunk - 1) / kChunk;
  if (leader && chunks > 0) diagonal(diag, dead, 0, warps, warp, lane, thr, sbox, img, cap);
  sync_cluster(cs);

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * kChunk, now = c & 1, prev = now ^ 1;
    // A. The leader's warp 0 resolves chunk c as the Jacobi fixpoint of its
    // diagonal: kept = live & ~(the words of the kept rows), from kept =
    // live, one OR-reduction over the warp a round (lane l holds rows l and
    // l + 32), until it holds. Rows at suppression depth d are final after
    // d rounds, and the fixpoint is the greedy keep set. It stores the kept
    // boxes, in rank order, in buffer c % 2 of every block. Meanwhile the
    // other warps suppress with chunk c - 1's kept rows: each tests the rows
    // of its list (alive, below chunk c) against every one of them, sets the
    // dead bits of the rows hit, and keeps the rest below chunk c + 1 listed,
    // compacted in place.
    if (leader && warp == 0) {
      const uint64_t* dg = reinterpret_cast<const uint64_t*>(diag);
      const uint64_t live = live_of(dead, 2 * c);
      const uint64_t d0 = dg[lane], d1 = dg[lane + 32];
      uint64_t kept = live;
      while (true) {
        const uint64_t mine = (((kept >> lane) & 1ull) ? d0 : 0ull) | (((kept >> (lane + 32)) & 1ull) ? d1 : 0ull);
        const uint64_t sup = ((uint64_t)__reduce_or_sync(kFull, (unsigned)(mine >> 32)) << 32)
                             | __reduce_or_sync(kFull, (unsigned)mine);
        const uint64_t next = live & ~sup;
        if (next == kept) break;  // uniform over the warp
        kept = next;
      }
      if (lane == 0) {
        dead[2 * c] = ~(uint32_t)kept;
        dead[2 * c + 1] = ~(uint32_t)(kept >> 32);
      }
      if (lane < cs) (lane == 0 ? misc : cluster.map_shared_rank(misc, lane))[1 + now] = __popcll(kept);
      for (int r = lane; r < kChunk; r += 32) {
        if ((kept >> r) & 1ull) {
          const int at = now * kChunk + __popcll(kept & ((1ull << r) - 1ull));
          const float4 q = box_of(c0 + r, sbox, img, cap);
          const float qa = area_of(q);
          kbox[at] = q;
          karea[at] = qa;
          for (int b = 1; b < cs; ++b) {
            cluster.map_shared_rank(kbox, b)[at] = q;
            cluster.map_shared_rank(karea, b)[at] = qa;
          }
        }
      }
    } else if (forwards && c > 0) {
      const int n = misc[1 + prev];
      const float4* kb = kbox + prev * kChunk;
      const float* ka = karea + prev * kChunk;
      int stays = 0;
      for (int base = 0; base < count; base += 32) {  // uniform over the warp
        const int li = base + lane;
        const bool active = li < count;
        const int row = active ? list[li] : 0;
        bool hit = false;
        if (n > 0) {
          const float4 q = active ? box_of(row, sbox, img, cap) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float qa = area_of(q);
          for (int k = 0; k < n; ++k) hit = overlaps(kb[k], ka[k], q, qa, thr, active) || hit;
        }
        if (hit) atomicOr(lead_dead + (row >> 5), 1u << (row & 31));
        const bool stay = active && !hit && row >= c0 + 2 * kChunk;
        const unsigned m = __ballot_sync(kFull, stay);  // every lane has read its row
        if (stay) list[stays + __popc(m & below)] = (uint16_t)row;
        stays += __popc(m);
      }
      count = stays;
    }
    // B. The leader suppresses chunk c + 1 with chunk c's kept rows, every
    // (row, kept row) pair spread over the block, then computes chunk c +
    // 1's diagonal between its rows alive now (a superset of those alive
    // when it is resolved).
    if (leader) {
      __syncthreads();
      const int n = misc[1 + now], c1 = c0 + kChunk;
      const float4* kb = kbox + now * kChunk;
      const float* ka = karea + now * kChunk;
      for (int p = t; p < kChunk * n; p += blockDim.x) {  // uniform over each warp
        const int row = c1 + (p & (kChunk - 1)), k = p >> 6;
        const bool active = row < nb;
        const float4 q = active ? box_of(row, sbox, img, cap) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (overlaps(kb[k], ka[k], q, area_of(q), thr, active)) atomicOr(&dead[row >> 5], 1u << (row & 31));
      }
      __syncthreads();
      if (c + 1 < chunks) diagonal(diag, dead, c + 1, warps, warp, lane, thr, sbox, img, cap);
    }
    sync_cluster(cs);
  }
  if (leader) {
    uint8_t* out = keep + image * N;
    for (int i = t; i < N; i += blockDim.x) out[i] = (uint8_t)(((dead[i >> 5] >> (i & 31)) & 1u) ^ 1u);
  }
}

// Rows of an image of N candidates that N1 stages in shared memory with
// `threads` a block on a card with `optin` bytes a block;
// ops/nms_kernel.smem_rows mirrors it.
int smem_rows(int N, int threads, int optin) {
  const long long rows = ((long long)optin - (long long)fixed_bytes(N, threads / 32)) / 16;
  return (int)(rows < 0 ? 0 : (rows < N ? rows : N));
}

// Blocks a cluster and threads a block for B images: the first of 8 x 1024,
// 4 x 1024, 4 x 512 and 2 x 512 with at most 65,536 threads in all, else
// 1 x 1024. On an H100 (132 SMs in GPCs of up to 18) more clusters than
// that no longer run in one wave, and a second wave doubles the time.
// ops/nms_kernel.launch_shape mirrors it.
struct Shape {
  int cluster, threads;
};

Shape launch_shape(int B) {
  const Shape shapes[] = {{8, 1024}, {4, 1024}, {4, 512}, {2, 512}};
  for (const Shape& sh : shapes)
    if ((long long)B * sh.cluster * sh.threads <= 65536) return sh;
  return {1, 1024};
}

// Per device: the shared memory a block may opt in to, read once, after
// which the kernel is allowed all of it.
std::atomic<int> g_optin[kMaxDevices];

cudaError_t device_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *optin = g_optin[dev].load();
  if (*optin == 0) {
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *optin);
    if (err != cudaSuccess) return err;
    g_optin[dev].store(*optin);
  }
  return cudaSuccess;
}

}  // namespace

// The launch tf_nms_keep makes for B images of N candidates on the current
// device: blocks a cluster, threads a block, rows staged in shared memory
// and the shared memory a block may opt in to.
extern "C" int tf_nms_shape(int B, int N, int* cluster, int* threads, int* staged, int* optin) {
  if (B < 1 || N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = device_optin(optin);
  if (err != cudaSuccess) return (int)err;
  const Shape shape = launch_shape(B);
  *cluster = shape.cluster;
  *threads = shape.threads;
  *staged = smem_rows(N, shape.threads, *optin);
  return 0;
}

extern "C" int tf_nms_keep(const float* boxes, const uint8_t* valid, int B, int N, float thr,
                           uint8_t* keep, void* stream) {
  int cs = 0, threads = 0, cap = 0, optin = 0;
  const int bad = tf_nms_shape(B, N, &cs, &threads, &cap, &optin);
  if (bad) return bad;
  if ((long long)B * cs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cs));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = fixed_bytes(N, threads / 32) + (size_t)cap * 16;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nms_keep_kernel, reinterpret_cast<const float4*>(boxes),
                                             valid, N, cap, thr, keep);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
