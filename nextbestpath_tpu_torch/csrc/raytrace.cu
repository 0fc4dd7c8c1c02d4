// Ray-triangle kernels of the port (K1 and K2).
//
// K1 nbp_ray_hits_pinhole replaces _ray_pinhole_kernel
//    (nextbestpath_tpu/ops/raytrace.py:234, launched by
//    _ray_hits_pinhole_pallas at :288): rays that share one origin against the
//    per-frame pinhole SoA [n; m2; m1; t_num] (10, F). det = -d.n,
//    u = -d.m2, v = d.m1, t = t_num / det.
// K2 nbp_ray_hits replaces _ray_kernel (raytrace.py:127, launched by
//    _ray_hits_pallas at :358): double-sided Moller-Trumbore with an origin
//    per ray against the general SoA [v0; e1; e2] (9, F); t is measured along
//    the unnormalised direction.
//
// Both return, per ray, the nearest t in (t_min, t_max) (3.4e38 for none), the
// number of hits, and the nearest triangle's index (the lowest on ties, -1
// for none).
//
// What bounds them on an H100: operations. A ray reads 12 bytes and writes 12,
// then tests every triangle: ~25 f32 operations a pair for K1, ~50 for K2,
// against a few bytes of triangle data that every ray of a block shares. The
// design: one thread per ray, triangles staged through shared memory in tiles
// of TILE so a block reads each triangle from device memory once, and a
// strict < over ascending triangle index for the lowest-index tie rule. The
// division runs only for a pair whose barycentric test passed. The loop bound,
// n_tris, is read from device memory, so the caller never syncs to the host.
#include "common.cuh"

#define TILE 256
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
ray_pinhole_kernel(const float* __restrict__ dirs, int n_rays,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, float t_min, float t_max,
                   float* __restrict__ t_out, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out) {
  __shared__ float tile[10][TILE];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < n_rays;
  float dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }
  const int n_tris = clamp_count(n_tris_p, f);
  float t_best = NBP_INF;
  int cnt = 0, best = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int m = min(TILE, n_tris - base);
    __syncthreads();
    for (int i = threadIdx.x; i < 10 * m; i += blockDim.x) {
      const int row = i / m, k = i - row * m;
      tile[row][k] = soa[row * f + base + k];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < m; ++k) {
      const float det = -dot3_rn(dx, dy, dz, tile[0][k], tile[1][k], tile[2][k]);
      const float u = -dot3_rn(dx, dy, dz, tile[3][k], tile[4][k], tile[5][k]);
      const float v = dot3_rn(dx, dy, dz, tile[6][k], tile[7][k], tile[8][k]);
      const float ad = fabsf(det);
      if (!(ad > NBP_DET_EPS)) continue;
      const float us = det < 0.f ? -u : u;
      const float vs = det < 0.f ? -v : v;
      if (!(us >= 0.f && vs >= 0.f && add_rn(us, vs) <= ad)) continue;
      const float t = __fdiv_rn(tile[9][k], det);
      if (!(t > t_min && t < t_max)) continue;
      ++cnt;
      if (t < t_best) {
        t_best = t;
        best = base + k;
      }
    }
  }
  if (active) {
    t_out[r] = t_best;
    cnt_out[r] = cnt;
    idx_out[r] = best;
  }
}

__global__ void __launch_bounds__(THREADS)
ray_general_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs, int n_rays,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, float t_min, float t_max,
                   float* __restrict__ t_out, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out) {
  __shared__ float tile[9][TILE];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (active) {
    ox = origins[3 * r];
    oy = origins[3 * r + 1];
    oz = origins[3 * r + 2];
    dx = dirs[3 * r];
    dy = dirs[3 * r + 1];
    dz = dirs[3 * r + 2];
  }
  const int n_tris = clamp_count(n_tris_p, f);
  float t_best = NBP_INF;
  int cnt = 0, best = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int m = min(TILE, n_tris - base);
    __syncthreads();
    for (int i = threadIdx.x; i < 9 * m; i += blockDim.x) {
      const int row = i / m, k = i - row * m;
      tile[row][k] = soa[row * f + base + k];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < m; ++k) {
      const float v0x = tile[0][k], v0y = tile[1][k], v0z = tile[2][k];
      const float e1x = tile[3][k], e1y = tile[4][k], e1z = tile[5][k];
      const float e2x = tile[6][k], e2y = tile[7][k], e2z = tile[8][k];
      // p = d x e2
      const float px = sub_rn(mul_rn(dy, e2z), mul_rn(dz, e2y));
      const float py = sub_rn(mul_rn(dz, e2x), mul_rn(dx, e2z));
      const float pz = sub_rn(mul_rn(dx, e2y), mul_rn(dy, e2x));
      const float det = dot3_rn(e1x, e1y, e1z, px, py, pz);
      const float sx = sub_rn(ox, v0x), sy = sub_rn(oy, v0y), sz = sub_rn(oz, v0z);
      const float u = dot3_rn(sx, sy, sz, px, py, pz);
      // q = s x e1
      const float qx = sub_rn(mul_rn(sy, e1z), mul_rn(sz, e1y));
      const float qy = sub_rn(mul_rn(sz, e1x), mul_rn(sx, e1z));
      const float qz = sub_rn(mul_rn(sx, e1y), mul_rn(sy, e1x));
      const float v = dot3_rn(dx, dy, dz, qx, qy, qz);
      const float ad = fabsf(det);
      if (!(ad > NBP_DET_EPS)) continue;
      const float us = det < 0.f ? -u : u;
      const float vs = det < 0.f ? -v : v;
      if (!(us >= 0.f && vs >= 0.f && add_rn(us, vs) <= ad)) continue;
      const float t_scaled = dot3_rn(e2x, e2y, e2z, qx, qy, qz);
      const float t = __fdiv_rn(t_scaled, det);
      if (!(t > t_min && t < t_max)) continue;
      ++cnt;
      if (t < t_best) {
        t_best = t;
        best = base + k;
      }
    }
  }
  if (active) {
    t_out[r] = t_best;
    cnt_out[r] = cnt;
    idx_out[r] = best;
  }
}

extern "C" int nbp_ray_hits_pinhole(const void* dirs, int n_rays,
                                    const void* soa, int f,
                                    const void* n_tris, float t_min,
                                    float t_max, void* t_out, void* cnt_out,
                                    void* idx_out, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    ray_pinhole_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)dirs, n_rays, (const float*)soa, f,
        (const int*)n_tris, t_min, t_max, (float*)t_out, (int*)cnt_out,
        (int*)idx_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int nbp_ray_hits(const void* origins, const void* dirs,
                            int n_rays, const void* soa, int f,
                            const void* n_tris, float t_min, float t_max,
                            void* t_out, void* cnt_out, void* idx_out,
                            void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + THREADS - 1) / THREADS;
    ray_general_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)origins, (const float*)dirs, n_rays,
        (const float*)soa, f, (const int*)n_tris, t_min, t_max,
        (float*)t_out, (int*)cnt_out, (int*)idx_out);
  }
  return (int)cudaGetLastError();
}
