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
// What bounds them on an H100: issued instructions. A ray reads 12 bytes (24
// for K2) and writes 12, then tests every triangle against a few bytes of
// triangle data that every ray of a block shares. With no FMA each operation
// is one instruction, so the ceiling is 128 a clock on each SM (~33.5e12 a
// second), half the 67 TFLOP/s rate at which PERF.md's bounds are counted.
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
// - The scene axis (JAX vmaps K1 over stacked scenes, one triangle count a
//   scene): frame b reads its count at n_tris[b * count_stride]. A stride
//   of 0 gives every frame the one count; a stride of 1 gives each frame
//   its own, so B scenes padded to a common F each stop at their own
//   count, and the launch costs the sum over the scenes, not B times the
//   largest. The padded rows past a count are never read.
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
// K2 needs 44 operations a pair: the origin difference s = o - v0 (3), the
// cross products p = d x e2 and q = s x e1 (18), the dots det, u and v (15),
// |det|, the two sign selects, u + v and the four compares (8; the dot
// t_scaled and the division, for the few pairs that pass, are left out).
// Over 67 TFLOP/s that is the bound; the no-FMA ceiling is twice it. On the
// planning path K2 casts a scene's tables once: 2,023 rays against 252
// triangles for the 17x17 lattice of `simple` (a 0.0007 ms ceiling), 23,548
// against 2,784 for the 58x58 lattice of `insane` (0.086 ms). The old design
// (one ray a thread, 256 threads a block, 5 launches a scene) ran 2 to 4
// blocks on the 132 SMs for those few rays, one warp a scheduler at most:
// each thread's serial walk over the triangles, latency after latency, was
// its time, not the operations. This design:
// - G lanes a ray, G a power of two from 1 to 32, chosen on the host from
//   n_rays and the SM count (nbp_ray_hits_lanes): the least G for which the
//   n_rays * G threads give every SM 16 warps, capped at 32. The 2,023 table
//   rays get G = 32 (506 blocks of 128 threads), `insane`'s 23,548 G = 4,
//   and a 116,736-ray frame G = 1, which is the old one ray a thread.
// - Lane j of a ray's group tests triangles j, j + G, j + 2G, ... of a tile
//   staged in shared memory as an AoS of three float4 a triangle (v0, e1,
//   e2 padded to 12 floats): 3 16-byte loads a pair, where the old (9, TILE)
//   SoA tile took 9 scalar ones. Neighbouring lanes read triangles 48 bytes
//   apart, which a quarter-warp serves from distinct banks.
// - Each lane keeps the running (t, idx) minimum and count of its own
//   triangles, in ascending order with a strict <, and in the same rounded
//   operation order as before: p, det, s, u, q, v, the |det| and signed u/v
//   tests, t_scaled, the division, the range test.
// - The group combines by __shfl_xor_sync over its G lanes: the counts are
//   summed (integers, exact) and (t, idx) is reduced to its lexicographic
//   minimum, "no hit" carried as idx = INT_MAX and written as -1. The
//   minimum is order-free and breaks ties to the lower index, as the strict <
//   over ascending index does, so t, the count and idx are bit-equal to the
//   plain version whatever G is.
// - One launch casts a scene's tables (sim/tables.py: the 3 L H inside-test
//   rays and the 4 L H lattice edges together), where the old path took 5.
//
// ptxas (sm_90a): K1 47 registers and 12,336 bytes of shared memory; K2 56
// registers and 12,288 bytes for every G; no spills.
#include <climits>

#include "common.cuh"

constexpr int K1_THREADS = 128;
constexpr int K1_TILE = 256;

__global__ void __launch_bounds__(K1_THREADS)
ray_pinhole_kernel(const float* __restrict__ dirs, int n_rays,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, int count_stride,
                   float t_min, float t_max, float* __restrict__ t_out,
                   int* __restrict__ cnt_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[3 * (K1_TILE + 1)];
  const size_t frame = blockIdx.y;
  dirs += frame * n_rays * 3;
  soa += frame * 10 * f;
  const int r = blockIdx.x * K1_THREADS + threadIdx.x;
  const int rc = min(r, n_rays - 1);
  const float dx = dirs[3 * rc], dy = dirs[3 * rc + 1], dz = dirs[3 * rc + 2];
  float t_best = NBP_INF;
  int cnt = 0, best = -1;
  const int n_tris = clamp_count(n_tris_p + frame * count_stride, f);
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

constexpr int K2_THREADS = 128;
constexpr int K2_TILE = 256;
constexpr int K2_WARPS_PER_SM = 16;

template <int G>
__global__ void __launch_bounds__(K2_THREADS)
ray_general_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs, int n_rays,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, float t_min, float t_max,
                   float* __restrict__ t_out, int* __restrict__ cnt_out,
                   int* __restrict__ idx_out) {
  __shared__ float4 tile[3 * K2_TILE];
  const int lane = threadIdx.x & (G - 1);
  const int r = (blockIdx.x * K2_THREADS + threadIdx.x) / G;
  // Every thread runs to the combine: a group past the last ray casts the
  // last ray again and writes nothing.
  const int rc = min(r, n_rays - 1);
  const float ox = origins[3 * rc], oy = origins[3 * rc + 1],
              oz = origins[3 * rc + 2];
  const float dx = dirs[3 * rc], dy = dirs[3 * rc + 1], dz = dirs[3 * rc + 2];
  const int n_tris = clamp_count(n_tris_p, f);
  float t_best = NBP_INF;
  int cnt = 0, best = INT_MAX;
  for (int base = 0; base < n_tris; base += K2_TILE) {
    const int m = min(K2_TILE, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += K2_THREADS) {
      float q[9];
#pragma unroll
      for (int row = 0; row < 9; ++row) q[row] = soa[row * f + base + k];
      tile[3 * k] = make_float4(q[0], q[1], q[2], q[3]);
      tile[3 * k + 1] = make_float4(q[4], q[5], q[6], q[7]);
      tile[3 * k + 2] = make_float4(q[8], 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int k = lane; k < m; k += G) {
      // v0 = (a.x, a.y, a.z), e1 = (a.w, b.x, b.y), e2 = (b.z, b.w, c.x).
      const float4 a = tile[3 * k], b = tile[3 * k + 1], c = tile[3 * k + 2];
      // p = d x e2
      const float px = sub_rn(mul_rn(dy, c.x), mul_rn(dz, b.w));
      const float py = sub_rn(mul_rn(dz, b.z), mul_rn(dx, c.x));
      const float pz = sub_rn(mul_rn(dx, b.w), mul_rn(dy, b.z));
      const float det = dot3_rn(a.w, b.x, b.y, px, py, pz);
      const float sx = sub_rn(ox, a.x), sy = sub_rn(oy, a.y),
                  sz = sub_rn(oz, a.z);
      const float u = dot3_rn(sx, sy, sz, px, py, pz);
      // q = s x e1
      const float qx = sub_rn(mul_rn(sy, b.y), mul_rn(sz, b.x));
      const float qy = sub_rn(mul_rn(sz, a.w), mul_rn(sx, b.y));
      const float qz = sub_rn(mul_rn(sx, b.x), mul_rn(sy, a.w));
      const float v = dot3_rn(dx, dy, dz, qx, qy, qz);
      const float ad = fabsf(det);
      const float us = det < 0.f ? -u : u;
      const float vs = det < 0.f ? -v : v;
      if ((ad > NBP_DET_EPS) & (us >= 0.f) & (vs >= 0.f) &
          (add_rn(us, vs) <= ad)) {
        const float t_scaled = dot3_rn(b.z, b.w, c.x, qx, qy, qz);
        const float t = __fdiv_rn(t_scaled, det);
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
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    const float t_o = __shfl_xor_sync(0xffffffffu, t_best, off);
    const int i_o = __shfl_xor_sync(0xffffffffu, best, off);
    if (t_o < t_best || (t_o == t_best && i_o < best)) {
      t_best = t_o;
      best = i_o;
    }
  }
  if (lane == 0 && r < n_rays) {
    t_out[r] = t_best;
    cnt_out[r] = cnt;
    idx_out[r] = best == INT_MAX ? -1 : best;
  }
}

template <int G>
static void launch_general(const void* origins, const void* dirs, int n_rays,
                           const void* soa, int f, const void* n_tris,
                           float t_min, float t_max, void* t_out,
                           void* cnt_out, void* idx_out, cudaStream_t st) {
  const long threads = (long)n_rays * G;
  const int blocks = (int)((threads + K2_THREADS - 1) / K2_THREADS);
  ray_general_kernel<G><<<blocks, K2_THREADS, 0, st>>>(
      (const float*)origins, (const float*)dirs, n_rays, (const float*)soa,
      f, (const int*)n_tris, t_min, t_max, (float*)t_out, (int*)cnt_out,
      (int*)idx_out);
}

// n_tris holds one count (count_stride 0) or one a frame (count_stride 1).
// Refuses (cudaErrorInvalidValue) a negative t_min, which the fold forbids,
// and a stride other than 0 or 1.
extern "C" int nbp_ray_hits_pinhole(const void* dirs, int n_frames,
                                    int n_rays, const void* soa, int f,
                                    const void* n_tris, int count_stride,
                                    float t_min, float t_max, void* t_out,
                                    void* cnt_out, void* idx_out,
                                    void* stream) {
  if (!(t_min >= 0.f) || count_stride < 0 || count_stride > 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays > 0 && n_frames > 0) {
    const dim3 grid((n_rays + K1_THREADS - 1) / K1_THREADS, n_frames);
    ray_pinhole_kernel<<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)dirs, n_rays, (const float*)soa, f,
        (const int*)n_tris, count_stride, t_min, t_max, (float*)t_out,
        (int*)cnt_out, (int*)idx_out);
  }
  return (int)cudaGetLastError();
}

// K2's lanes a ray: the least power of two G <= 32 for which n_rays * G
// threads give each of n_sm SMs K2_WARPS_PER_SM warps.
extern "C" int nbp_ray_hits_lanes(int n_rays, int n_sm) {
  const long want = (long)n_sm * K2_WARPS_PER_SM * 32;
  int g = 1;
  while (g < 32 && (long)n_rays * g < want) g *= 2;
  return g;
}

extern "C" int nbp_ray_hits(const void* origins, const void* dirs,
                            int n_rays, const void* soa, int f,
                            const void* n_tris, float t_min, float t_max,
                            void* t_out, void* cnt_out, void* idx_out,
                            void* stream) {
  if (n_rays > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (nbp_ray_hits_lanes(n_rays, sm_count())) {
#define NBP_K2_CASE(G)                                                     \
  case G:                                                                  \
    launch_general<G>(origins, dirs, n_rays, soa, f, n_tris, t_min, t_max, \
                      t_out, cnt_out, idx_out, st);                        \
    break;
      NBP_K2_CASE(1)
      NBP_K2_CASE(2)
      NBP_K2_CASE(4)
      NBP_K2_CASE(8)
      NBP_K2_CASE(16)
      NBP_K2_CASE(32)
#undef NBP_K2_CASE
    }
  }
  return (int)cudaGetLastError();
}
