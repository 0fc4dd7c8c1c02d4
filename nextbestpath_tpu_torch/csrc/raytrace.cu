// Ray-triangle kernels of the port (K1 and K2).
//
// K1 nbp_ray_hits_pinhole replaces _ray_pinhole_kernel
//    (nextbestpath_tpu/ops/raytrace.py:234, launched by
//    _ray_hits_pinhole_pallas at :288): B frames, each of N rays sharing one
//    origin, against the frame's pinhole SoA [n; m2; m1; t_num] (B, 10, F).
//    det = -d.n, u = -d.m2, v = d.m1, t = t_num / det.
// K2 nbp_ray_hits replaces _ray_kernel (raytrace.py:127, launched by
//    _ray_hits_pallas at :358): double-sided Moller-Trumbore with an origin
//    per ray against the general SoA [v0; e1; e2] (9, F); t is measured along
//    the unnormalised direction.
//
// Both return, per ray, the nearest t in (t_min, t_max) (3.4e38 for none), the
// number of hits, and the nearest triangle's index (the lowest on ties, -1
// for none): a strict < over ascending triangle index. The division runs
// only for a pair whose barycentric test passed. The loop bound, n_tris, is
// read from device memory, so the caller never syncs to the host. Products
// and sums round one by one (common.cuh), so t, counts and indices are
// bit-equal to the plain versions.
//
// What bounds them on an H100: issued instructions. A ray reads 12 bytes and
// writes 12, then tests every triangle against a few bytes of triangle data
// that every ray of a block shares. With no FMA each operation is one
// instruction, so the ceiling is 128 a clock on each SM (~33.5e12 a second),
// half the 67 TFLOP/s rate at which PERF.md's bounds are counted.
//
// K1 needs 20 operations a pair: three 3-term dots (15), the three sign and
// range compares of det, u and v, the add u + v and its compare (the
// division, for the few pairs that pass, is left out). That is 5.9e8 for a
// 256x456 frame of 252 triangles: a 17.6 us no-FMA ceiling. The kernel is
// laid out to spend its issue slots on them:
// - One ray a thread, 128 threads a block: 912 blocks a frame share out
//   over the 132 SMs with a short tail.
// - The triangle tile is staged as an AoS padded to 12 floats, three float4
//   per triangle: a triangle is 3 16-byte broadcast loads, not 10 scalar
//   ones. The staging transposes the (10, F) SoA of the block's frame. The
//   next triangle's three loads are issued before the current one's tests.
// - The triangle's sign is folded into its data (below), which takes the
//   negations, the two selects and |det| out of every pair: what is left is
//   the 20 operations above, with one branch a pair around the division.
//   Passes are rare (a ray's line crosses a few of the triangles), and a
//   warp's 32 neighbouring pixels pass alike.
// - Grid (ray blocks, B): a move's four frames are one launch.
//
// The fold: a hit that counts has t = t_num / det > t_min >= 0, so det has
// the sign s of t_num, which is one value a triangle. The staging multiplies
// n and m2 by -s and m1 by s (exact: a sign change or a zero) and stores
// |t_num|, so the kernel reads det' = s * det, u' = s * u = us and
// v' = s * v = vs directly: negating every term of a dot negates its rounded
// result exactly. The test det' > eps, u' >= 0, v' >= 0, u' + v' <= det'
// then accepts exactly the pairs the reference accepts with t > 0 (a pair
// with det of the other sign has t < 0 and is refused by t > t_min there),
// and |t_num| / det' is bit-equal to t_num / det. A triangle with t_num = 0
// gets zeros and can never pass; nor could it in the reference (t = 0). The
// fold needs t_min >= 0, which every depth frame has (t_min = znear); the
// entry point refuses a negative t_min.
//
// ptxas (sm_90a): K1 47 registers and 12,336 bytes of shared memory,
// K2 38 registers and 9,216 bytes, no spills.
// K2 keeps one ray a thread over a (9, TILE) SoA tile.
#include "common.cuh"

#define TILE 256
#define THREADS 256

constexpr int K1_THREADS = 128;
constexpr int K1_TILE = 256;

__global__ void __launch_bounds__(K1_THREADS)
ray_pinhole_kernel(const float* __restrict__ dirs, int n_rays,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, float t_min, float t_max,
                   float* __restrict__ t_out, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out) {
  __shared__ float4 tile[3 * (K1_TILE + 1)];
  const size_t frame = blockIdx.y;
  dirs += frame * n_rays * 3;
  soa += frame * 10 * f;
  const int r = blockIdx.x * K1_THREADS + threadIdx.x;
  const int rc = min(r, n_rays - 1);
  const float dx = dirs[3 * rc], dy = dirs[3 * rc + 1], dz = dirs[3 * rc + 2];
  float t_best = NBP_INF;
  int cnt = 0, best = -1;
  const int n_tris = clamp_count(n_tris_p, f);
  for (int base = 0; base < n_tris; base += K1_TILE) {
    const int m = min(K1_TILE, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += K1_THREADS) {
      float q[10];
#pragma unroll
      for (int row = 0; row < 10; ++row) q[row] = soa[row * f + base + k];
      const float sg = q[9] > 0.f ? 1.f : (q[9] < 0.f ? -1.f : 0.f);
#pragma unroll
      for (int row = 0; row < 6; ++row) q[row] = mul_rn(q[row], -sg);
#pragma unroll
      for (int row = 6; row < 9; ++row) q[row] = mul_rn(q[row], sg);
      tile[3 * k] = make_float4(q[0], q[1], q[2], q[3]);
      tile[3 * k + 1] = make_float4(q[4], q[5], q[6], q[7]);
      tile[3 * k + 2] = make_float4(q[8], fabsf(q[9]), 0.f, 0.f);
    }
    __syncthreads();
    // Folded n = (a.x, a.y, a.z), m2 = (a.w, b.x, b.y), m1 = (b.z, b.w, c.x),
    // |t_num| = c.y. The next triangle is read while this one is tested (the
    // tile has a spare slot for the read past the last).
    float4 na = tile[0], nb = tile[1], nc = tile[2];
    for (int k = 0; k < m; ++k) {
      const float4 a = na, b = nb, c = nc;
      na = tile[3 * k + 3];
      nb = tile[3 * k + 4];
      nc = tile[3 * k + 5];
      const float det = dot3_rn(dx, dy, dz, a.x, a.y, a.z);
      const float us = dot3_rn(dx, dy, dz, a.w, b.x, b.y);
      const float vs = dot3_rn(dx, dy, dz, b.z, b.w, c.x);
      if ((det > NBP_DET_EPS) & (us >= 0.f) & (vs >= 0.f) &
          (add_rn(us, vs) <= det)) {
        const float t = __fdiv_rn(c.y, det);
        if (t > t_min && t < t_max) {
          ++cnt;
          if (t < t_best) {
            t_best = t;
            best = base + k;
          }
        }
      }
    }
  }
  if (r < n_rays) {
    t_out += frame * n_rays;
    cnt_out += frame * n_rays;
    idx_out += frame * n_rays;
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

// Refuses (cudaErrorInvalidValue) a negative t_min, which the fold forbids.
extern "C" int nbp_ray_hits_pinhole(const void* dirs, int n_frames,
                                    int n_rays, const void* soa, int f,
                                    const void* n_tris, float t_min,
                                    float t_max, void* t_out, void* cnt_out,
                                    void* idx_out, void* stream) {
  if (!(t_min >= 0.f)) return (int)cudaErrorInvalidValue;
  if (n_rays > 0 && n_frames > 0) {
    const dim3 grid((n_rays + K1_THREADS - 1) / K1_THREADS, n_frames);
    ray_pinhole_kernel<<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
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
