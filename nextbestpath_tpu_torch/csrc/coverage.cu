// Running-min squared distance kernel of the port (K3).
//
// nbp_min_sq_dists replaces _min_dist_kernel
// (nextbestpath_tpu/ops/coverage.py:109, launched by _min_dists_pallas at
// :134): for each GT point, the minimum squared distance over the sampled
// points, from the differences in exact f32 (not |a|^2 + |b|^2 - 2ab).
// Invalid samples were moved to the 1e9 sentinel by the caller; only the
// valid prefix is read, and its length is read from device memory. The
// scene axis (JAX vmaps K3 over stacked scenes: (B, G, 3) GT, (B, S, 3)
// samples and a count a scene) is the same launch; a single scene is B = 1.
//
// What bounds it on an H100: issued instructions. The inputs are under 1 MB
// a scene; each (GT, sample) pair costs 9 f32 operations (three
// differences, three squares, two adds, one min), 7.4e9 at 20000 x 40960.
// The products and sums are rounded one by one (common.cuh: no FMA, so the
// result equals the plain version's bits), so each operation is one
// instruction and the card's ceiling is 128 of them a clock on each SM,
// about 33.5e12 a second: half the 67 TFLOP/s that counts an FMA as two.
// At the main path's shape that ceiling is about 0.22 ms.
//
// The work is the valid pairs, sum_b G * count_b, and the counts live on
// the device (a capture sees no host value), so the split is made there:
// - A work item is (scene, GT block of P * THREADS points, sample range)
//   over that scene's valid prefix only. Block 0 of the fill kernel (below)
//   reads the B counts and writes the plan into scratch the wrapper
//   allocates:
//   the sample-chunk length of the launch, chosen from the sum of the
//   counts so that there are about ITEMS_PER_BLOCK items a resident block
//   (a multiple of TILE, never less than one tile), and the exclusive
//   prefix of the item counts over the scenes. k3_chunk below is the rule,
//   and kernels.min_sq_dists_plan is the same rule on the host.
// - The distance kernel is persistent: as many blocks as the card holds at
//   once (SM count x blocks an SM, from the occupancy API on the host, no
//   device read). Each block draws items by atomicAdd on a counter, finds
//   the item's scene by a binary search over the prefix, and returns when
//   the items run out. A scene of count 0 has no items; blocks never read
//   past a count. With several items a block, the blocks that draw short
//   items (a scene's ragged last chunk) draw more, and the SMs finish
//   together.
// - A block draws its next item while it stages the last tile of the
//   current one: the atomic's latency hides behind that tile's pairs, and
//   no block claims an item long before it can start it. Drawn at the
//   start of the current item instead, the early blocks took items that
//   idle blocks could have run: up to one item's length of tail.
// - The fill kernel writes the 1e30 "no sample" value over the output,
//   resets the counter, so every replay of a captured graph starts at 0,
//   and makes the plan in its block 0: one launch before the distance
//   kernel, which the stream orders after it.
//
// Inside an item:
// - Register tile: each thread holds P GT points and their running minima
//   in registers, so one shared-memory read of a sample feeds P pairs.
// - Samples are staged as float4 (x, y, z, pad) tiles of TILE, packed while
//   they are copied from the (S, 3) input: one 16-byte broadcast load a
//   sample.
// - The partial minima meet by atomicMin on the int bit pattern of d^2. d^2
//   is never negative, and for non-negative floats the int order is the
//   float order (the 1e9 sentinel gives ~3e18, finite, below the 1e30 fill).
//   A min is exact and does not depend on order, so the result is bit-equal
//   to the plain version whatever items the blocks draw and in what order.
//
// P = 8 GT points a thread, 128 threads: at 20000 x 40960 that is 20 GT
// blocks; the chunk falls to two tiles (128 samples), 6,400 items. A tile
// of 64 samples (half the threads stage it) keeps the items small enough
// at partial counts (12,345 valid: 3,860 items) for the blocks to share
// them out evenly; 128 served the full count as well and partial counts
// worse. ptxas (sm_90a): 64 registers and 1,028 bytes of shared memory, 8
// blocks an SM (1,056 on 132 SMs), no spills; the fill kernel 32 registers
// and 388 bytes.
#include <algorithm>

#include "common.cuh"

constexpr int P = 8;
constexpr int THREADS = 128;
constexpr int POINTS = P * THREADS;  // GT points an item
constexpr int TILE = 64;             // samples staged at once; the least chunk
constexpr int ITEMS_PER_BLOCK = 8;   // items wanted for each resident block
constexpr int FILL_THREADS = 1024;
constexpr float NO_SAMPLE = 1e30f;

// The plan, int32: [0] the item counter, [1] the chunk, [2 + b] the items
// of the scenes before scene b, for b = 0 .. n_b ([2 + n_b]: all items).
constexpr int PLAN_COUNTER = 0, PLAN_CHUNK = 1, PLAN_PREFIX = 2;

// The chunk for `total` valid samples over all scenes, n_gb GT blocks a
// scene and `target` items wanted: total * n_gb / target samples rounded up
// to whole tiles, at least one tile and at most the tiles of n_s.
__host__ __device__ inline int k3_chunk(long long total, int n_gb, int n_s,
                                        long long target) {
  const long long want = (total * n_gb + target - 1) / target;
  long long tiles = (want + TILE - 1) / TILE;
  long long most = ((long long)n_s + TILE - 1) / TILE;
  most = most < 1 ? 1 : most;
  tiles = tiles < 1 ? 1 : (tiles > most ? most : tiles);
  return (int)(tiles * TILE);
}

// The plan of the counts (n_b of them) into plan, by one block of
// FILL_THREADS threads.
__device__ void make_plan(const int* __restrict__ counts, int n_b, int n_gb,
                          int n_s, long long target, int* __restrict__ plan) {
  constexpr int WARPS = FILL_THREADS / 32;
  __shared__ long long part[WARPS];
  __shared__ int warp_sum[WARPS];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) plan[PLAN_COUNTER] = 0;
  // The sum of the valid counts.
  long long sum = 0;
  for (int b = threadIdx.x; b < n_b; b += FILL_THREADS)
    sum += clamp_count(counts + b, n_s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) part[warp] = sum;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < WARPS; ++w) total += part[w];
  const int chunk = k3_chunk(total, n_gb, n_s, target);
  if (threadIdx.x == 0) plan[PLAN_CHUNK] = chunk;
  // The exclusive prefix of the items over the scenes, FILL_THREADS scenes
  // at a time, with the running total carried across.
  for (int b0 = 0; b0 < n_b; b0 += FILL_THREADS) {
    const int b = b0 + threadIdx.x;
    int items = 0;
    if (b < n_b) items = n_gb * ((clamp_count(counts + b, n_s) + chunk - 1) / chunk);
    int x = items;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp ? warp_sum[warp - 1] : 0) + x - items;
    if (b < n_b) plan[PLAN_PREFIX + b] = excl;
    __syncthreads();
    if (threadIdx.x == FILL_THREADS - 1) carry = excl + items;
    __syncthreads();
  }
  if (threadIdx.x == 0) plan[PLAN_PREFIX + n_b] = carry;
}

// out[:n] = v; block 0 also resets the item counter and makes the plan.
__global__ void __launch_bounds__(FILL_THREADS)
fill_plan_kernel(float* __restrict__ out, int n, float v,
                 const int* __restrict__ counts, int n_b, int n_gb, int n_s,
                 long long target, int* __restrict__ plan) {
  const int i = blockIdx.x * FILL_THREADS + threadIdx.x;
  if (i < n) out[i] = v;
  if (blockIdx.x == 0) make_plan(counts, n_b, n_gb, n_s, target, plan);
}

__global__ void __launch_bounds__(THREADS)
min_sq_dist_kernel(const float* __restrict__ g, int n_g,
                   const float* __restrict__ s, int n_s,
                   const int* __restrict__ counts, int n_b,
                   int* __restrict__ plan, float* __restrict__ out) {
  __shared__ float4 tile[TILE];
  __shared__ int drawn;
  const int n_gb = (n_g + POINTS - 1) / POINTS;
  const int chunk = plan[PLAN_CHUNK];
  const int* prefix = plan + PLAN_PREFIX;
  const int n_items = prefix[n_b];
  if (threadIdx.x == 0) drawn = atomicAdd(plan + PLAN_COUNTER, 1);
  __syncthreads();
  int item = drawn;
  while (item < n_items) {
    int ahead = 0;  // thread 0's draw of the next item, in the last tile
    // The item's scene: the last b with prefix[b] <= item (a scene with no
    // items shares its prefix with the next one and is passed over).
    int lo = 0, hi = n_b - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= item) lo = mid;
      else hi = mid - 1;
    }
    const size_t scene = lo;
    const int local = item - prefix[lo];
    const int n = clamp_count(counts + lo, n_s);
    const int s0 = (local / n_gb) * chunk;
    const int s1 = s0 + min(chunk, n - s0);
    const float* gs = g + scene * n_g * 3;
    const float* ss = s + scene * n_s * 3;

    // GT points i0 + k * THREADS, k < P: a warp's loads stay coalesced.
    const int i0 = (local % n_gb) * POINTS + threadIdx.x;
    float gx[P], gy[P], gz[P], best[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = min(i0 + k * THREADS, n_g - 1);
      gx[k] = gs[3 * i];
      gy[k] = gs[3 * i + 1];
      gz[k] = gs[3 * i + 2];
      best[k] = NO_SAMPLE;
    }
    for (int base = s0; base < s1; base += TILE) {
      const int m = min(TILE, s1 - base);
      __syncthreads();
      if (threadIdx.x < m) {
        const float* p = ss + 3 * (base + threadIdx.x);
        tile[threadIdx.x] = make_float4(p[0], p[1], p[2], 0.f);
      }
      if (threadIdx.x == 0 && base + TILE >= s1)
        ahead = atomicAdd(plan + PLAN_COUNTER, 1);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const float4 q = tile[j];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float dx = sub_rn(gx[k], q.x);
          const float dy = sub_rn(gy[k], q.y);
          const float dz = sub_rn(gz[k], q.z);
          best[k] = fminf(best[k], dot3_rn(dx, dy, dz, dx, dy, dz));
        }
      }
    }
    float* os = out + scene * n_g;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = i0 + k * THREADS;
      if (i < n_g) atomicMin(reinterpret_cast<int*>(os + i), __float_as_int(best[k]));
    }
    __syncthreads();
    if (threadIdx.x == 0) drawn = ahead;
    __syncthreads();
    item = drawn;
  }
}

// The distance kernel's blocks a launch: the blocks an SM holds at once
// (occupancy API) times the SM count, for the current device.
extern "C" int nbp_min_sq_dists_blocks() {
  int dev = 0, per_sm = 1;
  cudaGetDevice(&dev);
  static int cached[64] = {0};
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, min_sq_dist_kernel,
                                                THREADS, 0);
  const int n = std::max(1, per_sm) * sm_count();
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

static bool k3_shape_ok(int n_b, int n_g, int n_s) {
  return n_b >= 1 && n_b <= 65535 && n_g >= 0 && n_s >= 0 &&
         n_s <= 0x7fffffff - TILE;
}

// Fills out (n_out floats) with NO_SAMPLE and writes the plan of n_b
// scenes of n_g GT points and the counts s_count (n_b,) on the device, for
// n_blocks resident blocks, into plan (n_b + 3 int32), the counter at 0.
static void fill_plan(void* out, int n_out, const void* s_count, int n_b,
                      int n_g, int n_s, int n_blocks, void* plan,
                      cudaStream_t st) {
  const int n_gb = (n_g + POINTS - 1) / POINTS;
  fill_plan_kernel<<<std::max(1, (n_out + FILL_THREADS - 1) / FILL_THREADS),
                     FILL_THREADS, 0, st>>>(
      (float*)out, n_out, NO_SAMPLE, (const int*)s_count, n_b, n_gb, n_s,
      (long long)ITEMS_PER_BLOCK * n_blocks, (int*)plan);
}

// The plan alone (fill_plan with no output), for n_blocks resident blocks.
// Refuses (cudaErrorInvalidValue) the shapes nbp_min_sq_dists refuses.
extern "C" int nbp_min_sq_dists_plan(const void* s_count, int n_b, int n_g,
                                     int n_s, int n_blocks, void* plan,
                                     void* stream) {
  if (!k3_shape_ok(n_b, n_g, n_s) || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  fill_plan(nullptr, 0, s_count, n_b, n_g, n_s, n_blocks, plan,
            (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// n_b scenes: g (n_b, n_g, 3), s (n_b, n_s, 3), s_count (n_b,) on the
// device, plan scratch (n_b + 3 int32) -> out (n_b, n_g). Refuses
// (cudaErrorInvalidValue) n_b outside [1, 65535] and n_s past INT_MAX less
// a tile.
extern "C" int nbp_min_sq_dists(const void* g, int n_b, int n_g,
                                const void* s, int n_s, const void* s_count,
                                void* plan, void* out, void* stream) {
  if (!k3_shape_ok(n_b, n_g, n_s)) return (int)cudaErrorInvalidValue;
  if (n_g > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int n_blocks = nbp_min_sq_dists_blocks();
    fill_plan(out, n_b * n_g, s_count, n_b, n_g, n_s, n_blocks, plan, st);
    if (n_s > 0) {
      min_sq_dist_kernel<<<n_blocks, THREADS, 0, st>>>(
          (const float*)g, n_g, (const float*)s, n_s, (const int*)s_count,
          n_b, (int*)plan, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
