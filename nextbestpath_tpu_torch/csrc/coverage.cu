// Running-min squared distance kernel of the port (K3).
//
// nbp_min_sq_dists replaces _min_dist_kernel
// (nextbestpath_tpu/ops/coverage.py:109, launched by _min_dists_pallas at
// :134): for each GT point, the minimum squared distance over the sampled
// points, from the differences in exact f32 (not |a|^2 + |b|^2 - 2ab).
// Invalid samples were moved to the 1e9 sentinel by the caller; the loop runs
// over the valid prefix, whose length is read from device memory.
//
// What bounds it on an H100: operations. The inputs are 20000 x 3 and
// 40960 x 3 floats (under 1 MB) and the work is ~9 f32 operations for each of
// up to 8.2e8 pairs. The design: one thread per GT point keeps its running
// min in a register; a block of THREADS points walks the samples in tiles of
// TILE staged through shared memory, so each sample is read from device
// memory once per block and from shared memory as a broadcast. No atomics:
// every output has one writer.
#include "common.cuh"

#define TILE 1024
#define THREADS 128

__global__ void __launch_bounds__(THREADS)
min_sq_dist_kernel(const float* __restrict__ g, int n_g,
                   const float* __restrict__ s, int n_s,
                   const int* __restrict__ s_count_p,
                   float* __restrict__ out) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_g;
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (active) {
    gx = g[3 * i];
    gy = g[3 * i + 1];
    gz = g[3 * i + 2];
  }
  const int n = clamp_count(s_count_p, n_s);
  float best = 1e30f;
  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      sx[k] = s[3 * (base + k)];
      sy[k] = s[3 * (base + k) + 1];
      sz[k] = s[3 * (base + k) + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < m; ++k) {
      const float dx = sub_rn(gx, sx[k]);
      const float dy = sub_rn(gy, sy[k]);
      const float dz = sub_rn(gz, sz[k]);
      best = fminf(best, dot3_rn(dx, dy, dz, dx, dy, dz));
    }
  }
  if (active) out[i] = best;
}

extern "C" int nbp_min_sq_dists(const void* g, int n_g, const void* s,
                                int n_s, const void* s_count, void* out,
                                void* stream) {
  if (n_g > 0) {
    const int blocks = (n_g + THREADS - 1) / THREADS;
    min_sq_dist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)g, n_g, (const float*)s, n_s, (const int*)s_count,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
