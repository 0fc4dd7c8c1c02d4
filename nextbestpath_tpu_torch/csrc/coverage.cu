// Running-min squared distance kernel of the port (K3).
//
// nbp_min_sq_dists replaces _min_dist_kernel
// (nextbestpath_tpu/ops/coverage.py:109, launched by _min_dists_pallas at
// :134): for each GT point, the minimum squared distance over the sampled
// points, from the differences in exact f32 (not |a|^2 + |b|^2 - 2ab).
// Invalid samples were moved to the 1e9 sentinel by the caller; the loop runs
// over the valid prefix, whose length is read from device memory.
//
// What bounds it on an H100: issued instructions. The inputs are under 1 MB;
// each (GT, sample) pair costs 9 f32 operations (three differences, three
// squares, two adds, one min), 7.4e9 at 20000 x 40960. The products and sums
// are rounded one by one (common.cuh: no FMA, so the result equals the plain
// version's bits), so each operation is one instruction and the card's
// ceiling is 128 of them a clock on each SM, about 33.5e12 a second: half the
// 67 TFLOP/s that counts an FMA as two. At the main path's shape that ceiling
// is about 0.22 ms, against a 0.110 ms bound at the FMA rate.
//
// The design keeps the issue slots on arithmetic and the card full:
// - Register tile: each thread holds P GT points and their running minima in
//   registers, so one shared-memory read of a sample feeds P pairs.
// - Samples are staged as float4 (x, y, z, pad) tiles of TILE, packed while
//   they are copied from the (S, 3) input: one 16-byte broadcast load a
//   sample. Staging is plain loads, not cp.async: it is 3 loads a sample
//   against 9 * P * THREADS operations on it, under 0.1% of the issue slots,
//   and other resident blocks run while one block waits at its barrier.
// - The samples are split across blocks: grid (ceil(G / (P * THREADS)),
//   splits), with the split chosen on the host from the capacity n_s so that
//   4 to 8 blocks of 4 warps are resident on every SM (>= 528 blocks on 132
//   SMs) and shared out evenly over them (nbp_min_sq_dists_tiling). The count
//   stays on the device: a block whose range starts at or past it returns at
//   once.
// - The partial minima meet by atomicMin on the int bit pattern of d^2. d^2
//   is never negative, and for non-negative floats the int order is the float
//   order (the 1e9 sentinel gives ~3e18, finite, below the 1e30 fill). A min
//   is exact and does not depend on order, so the result is bit-equal to the
//   plain version whatever order the blocks run in. The entry point fills
//   the output with 1e30 first (a count of 0 leaves it so).
//
// The scene axis (JAX vmaps K3 over stacked scenes: (B, G, 3) GT, (B, S, 3)
// samples and a count a scene): grid (GT blocks, splits, B), block z reading
// its scene's rows and its count on the device, so a capture sees no host
// value. The split is chosen for the B x GT blocks of the launch, and the
// fill covers B x G. A single scene is B = 1.
//
// P = 8 GT points a thread, 128 threads: at 20000 x 40960 that is 20 x 33
// blocks of 1242 samples, 5 to an SM. Of the register tiles tried on the
// card, P = 8 was fastest at the full count, which 99 of a rollout's 101
// poses see; a smaller P runs more blocks when only a third of the samples
// are valid (the first poses). ptxas (sm_90a): 56 registers and 8,192
// bytes of shared memory, no spills; the fill kernel 10 registers.
#include <algorithm>

#include "common.cuh"

constexpr int P = 8;
constexpr int THREADS = 128;
constexpr int TILE = 512;
constexpr int MIN_CHUNK = 256;
constexpr float NO_SAMPLE = 1e30f;

__global__ void fill_kernel(float* __restrict__ out, int n, float v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v;
}

__global__ void __launch_bounds__(THREADS)
min_sq_dist_kernel(const float* __restrict__ g, int n_g,
                   const float* __restrict__ s, int n_s, int chunk,
                   const int* __restrict__ s_count_p,
                   float* __restrict__ out) {
  __shared__ float4 tile[TILE];
  const size_t scene = blockIdx.z;
  g += scene * n_g * 3;
  s += scene * n_s * 3;
  out += scene * n_g;
  const int n = clamp_count(s_count_p + scene, n_s);
  const int s0 = blockIdx.y * chunk;
  if (s0 >= n) return;
  const int s1 = min(s0 + chunk, n);

  // GT points i0 + k * THREADS, k < P: a warp's loads stay coalesced.
  const int i0 = blockIdx.x * (P * THREADS) + threadIdx.x;
  float gx[P], gy[P], gz[P], best[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = min(i0 + k * THREADS, n_g - 1);
    gx[k] = g[3 * i];
    gy[k] = g[3 * i + 1];
    gz[k] = g[3 * i + 2];
    best[k] = NO_SAMPLE;
  }

  for (int base = s0; base < s1; base += TILE) {
    const int m = min(TILE, s1 - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += THREADS) {
      const float* p = s + 3 * (base + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
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
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = i0 + k * THREADS;
    if (i < n_g) atomicMin(reinterpret_cast<int*>(out + i), __float_as_int(best[k]));
  }
}

// The tiling for n_b scenes of n_g GT points against a capacity of n_s
// samples on a card of n_sm SMs: tiling[0] GT points a block, tiling[1]
// samples a split, tiling[2] splits. Of the split counts that give 4 to 8
// blocks an SM (all resident at once: a block is 4 warps), it takes the one
// whose blocks share out most evenly over the SMs, each split at least
// MIN_CHUNK samples long.
extern "C" void nbp_min_sq_dists_tiling(int n_b, int n_g, int n_s, int n_sm,
                                        int* tiling) {
  const int gx = std::max(1, n_b * ((n_g + P * THREADS - 1) / (P * THREADS)));
  const int most = std::max(1, (n_s + MIN_CHUNK - 1) / MIN_CHUNK);
  const int lo = std::min(most, std::max(1, (4 * n_sm + gx - 1) / gx));
  const int hi = std::min(most, std::max(lo, 8 * n_sm / gx));
  int splits = lo;
  double best = 1e30;
  for (int k = lo; k <= hi; ++k) {
    const long blocks = (long)gx * k;
    const double waste = (double)((blocks + n_sm - 1) / n_sm * n_sm) / blocks;
    if (waste < best - 1e-9) {
      best = waste;
      splits = k;
    }
  }
  const int chunk = std::max(1, (n_s + splits - 1) / splits);
  tiling[0] = P * THREADS;
  tiling[1] = chunk;
  tiling[2] = std::max(1, (n_s + chunk - 1) / chunk);
}

// n_b scenes: g (n_b, n_g, 3), s (n_b, n_s, 3), s_count (n_b,) on the
// device -> out (n_b, n_g). Refuses (cudaErrorInvalidValue) n_b outside
// [1, 65535], the grid's z limit.
extern "C" int nbp_min_sq_dists(const void* g, int n_b, int n_g,
                                const void* s, int n_s, const void* s_count,
                                void* out, void* stream) {
  if (n_b < 1 || n_b > 65535) return (int)cudaErrorInvalidValue;
  if (n_g > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const int n_out = n_b * n_g;
    fill_kernel<<<(n_out + 255) / 256, 256, 0, st>>>((float*)out, n_out,
                                                      NO_SAMPLE);
    int tiling[3];
    nbp_min_sq_dists_tiling(n_b, n_g, n_s, sm_count(), tiling);
    if (n_s > 0) {
      const dim3 grid((n_g + tiling[0] - 1) / tiling[0], tiling[2], n_b);
      min_sq_dist_kernel<<<grid, THREADS, 0, st>>>(
          (const float*)g, n_g, (const float*)s, n_s, tiling[1],
          (const int*)s_count, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
