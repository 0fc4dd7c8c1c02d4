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
// only for a pair whose barycentric test passed. The triangle count is read
// from device memory, so the caller never syncs to the host. Products and
// sums round one by one (common.cuh), so t, counts and indices are
// bit-equal to the plain versions.
//
// K1: cull the triangles for a tile of rays, then test the survivors.
// A ray's line crosses only a few of a scene's triangles, and neighbouring
// pixels see the same few. Testing every pair keeps K1 bound by issued
// instructions: 20 operations a pair (three 3-term dots, the compares of
// det, u and v, the add u + v and its compare), about 26 instructions a
// pair in SASS with the shared-memory loads and the branch (PERF.md
// section 7). So:
// - A block owns an 8 x 16 pixel tile (8 rows of 16 columns) of one frame,
//   a row-major image whose width the launcher is given (the depth
//   renderers pass it), the tiles at the right and bottom edges ragged and
//   masked. One ray a thread. Grid (ray tiles, B): a move's four frames are
//   one launch.
// - The block reduces the per-component min and max of its rays' directions
//   (warp shuffles, then shared memory): the ray box.
// - The triangles are staged K1_THREADS at a time, one a thread, read one
//   round ahead. Each is folded (below), then tested against the box: it is
//   dropped when some predicate of the folded test fails for every
//   direction in the box. The survivors go into the shared tile with their
//   indices, in ascending index order, compacted by a __ballot_sync /
//   __popc prefix over the warps.
// - When the tile could overflow in the next round, or the triangles end,
//   every ray tests the survivors with the arithmetic, fold and strict <
//   as before (the next survivor is read while the current one is tested).
//   A dropped triangle fails the test for every ray of the block, so t, the
//   count and the index are bit-equal to testing every pair.
// On procgen `simple`/8 an 8 x 16 tile keeps about 2% of the triangles, on
// `insane`/8 about 1%. The function then needs little more than bytes:
// the rays read and the outputs written (24 B a ray) and each frame's
// triangle SoA (40 B a triangle) once; chip_smoke.py's bound is that, or
// the tested pairs' operations where they are more. The kernel does more:
// each block reads its frame's SoA (mostly from L2) and spends about 85
// operations a triangle on the cull.
//
// The cull. Over the box D = [lo, hi] of a block's directions, with
// mag_i = max(|lo_i|, |hi_i|), the pair loop computes det = dot3_rn(d, n'),
// us = dot3_rn(d, m2'), vs = dot3_rn(d, m1') and passes a pair iff
// det > eps, us >= 0, vs >= 0 and rn(us + vs) <= det. A 3-term dot rounded
// op by op is within gamma_3 * sum_i |d_i| |w_i| of d.w (gamma_3 = 3u / (1 -
// 3u), u = 2^-24), plus an absolute 2^-149 a product for underflow. Let
// S = sum_i mag_i (|n'_i| + |m2'_i| + |m1'_i|) and the margin
// M = 2^-21 S + 2^-120 (8u S: above every error term below). Upper and
// lower bounds of a linear form over D are taken at the box's corners,
// max_D d.w = sum_i max(lo_i w_i, hi_i w_i), computed with round-up
// (__fmul_ru, __fadd_ru; round-down for the lower bound), so that each is a
// bound of the exact value. A triangle is dropped when
//   (1) max_D d.n' + M <= eps: det <= d.n' + gamma_3 S <= eps on all of D;
//   (2) max_D d.m2' + M < 0: us < 0 on all of D; (3) the same for m1';
//   (4) min_D d.w~ - M > 0, w~ = rn(rn(m2' + m1') - n'): on all of D,
//       us + vs - det >= d.(m2' + m1' - n') - gamma_3 S
//                      >= d.w~ - (gamma_2 + gamma_3) S,
//       and rn(us + vs) >= (us + vs) - u |us + vs| with
//       |us + vs| <= (1 + gamma_3) S, so rn(us + vs) - det >=
//       min_D d.w~ - 6.01u S > 0, and rn(us + vs) <= det fails.
// Each clause fails on all of D, so no pair of the block that the pair loop
// would pass is dropped. A triangle whose S is not finite is kept, and a
// box that is not finite (an infinite or NaN direction throughout) keeps
// every triangle. ops/raytrace.py::pinhole_cull_keep is this test in
// PyTorch, each directed rounding taken one float further (nextafter), a
// bound at least as loose.
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
// The scene axis (JAX vmaps K1 over stacked scenes, one triangle count a
// scene): frame b reads its count at n_tris[b * count_stride]. A stride of
// 0 gives every frame the one count; a stride of 1 gives each frame its
// own, so B scenes padded to a common F each stop at their own count. The
// padded rows past a count are never read.
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
// ptxas (sm_90a): K1 70 registers and 13,472 bytes of shared memory (7
// blocks an SM); K2 56 registers and 12,288 bytes for every G; no spills.
#include <climits>

#include "common.cuh"

constexpr int K1_THREADS = 128;
constexpr int K1_TW = 16, K1_TH = 8;  // a block's pixel tile: 16 columns, 8 rows
constexpr int K1_TILE = 256;          // survivors held in shared memory
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr float K1_MARGIN = 4.76837158203125e-7f;  // 2^-21 = 8u
constexpr float K1_TINY = 7.52316384526264e-37f;   // 2^-120

struct RayBox {
  float lo[3], hi[3], mag[3];
};

// max over the box of d.w, rounded up: at least the exact maximum.
__device__ __forceinline__ float box_max_ru(const RayBox& bx, float w0,
                                            float w1, float w2) {
  const float a = fmaxf(__fmul_ru(bx.lo[0], w0), __fmul_ru(bx.hi[0], w0));
  const float b = fmaxf(__fmul_ru(bx.lo[1], w1), __fmul_ru(bx.hi[1], w1));
  const float c = fmaxf(__fmul_ru(bx.lo[2], w2), __fmul_ru(bx.hi[2], w2));
  return __fadd_ru(__fadd_ru(a, b), c);
}

// min over the box of d.w, rounded down: at most the exact minimum.
__device__ __forceinline__ float box_min_rd(const RayBox& bx, float w0,
                                            float w1, float w2) {
  const float a = fminf(__fmul_rd(bx.lo[0], w0), __fmul_rd(bx.hi[0], w0));
  const float b = fminf(__fmul_rd(bx.lo[1], w1), __fmul_rd(bx.hi[1], w1));
  const float c = fminf(__fmul_rd(bx.lo[2], w2), __fmul_rd(bx.hi[2], w2));
  return __fadd_rd(__fadd_rd(a, b), c);
}

// The folded triangle q (n' = q[0..2], m2' = q[3..5], m1' = q[6..8]) fails
// the pair test for every direction of the box (the note above).
__device__ __forceinline__ bool culled(const RayBox& bx, const float* q) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    s = __fadd_ru(s, __fmul_ru(bx.mag[i],
                               __fadd_ru(__fadd_ru(fabsf(q[i]), fabsf(q[3 + i])),
                                         fabsf(q[6 + i]))));
  const float m = __fadd_ru(__fmul_ru(K1_MARGIN, s), K1_TINY);
  const bool no_det = __fadd_ru(box_max_ru(bx, q[0], q[1], q[2]), m) <= NBP_DET_EPS;
  const bool no_u = __fadd_ru(box_max_ru(bx, q[3], q[4], q[5]), m) < 0.f;
  const bool no_v = __fadd_ru(box_max_ru(bx, q[6], q[7], q[8]), m) < 0.f;
  const bool no_sum =
      __fsub_rd(box_min_rd(bx, sub_rn(add_rn(q[3], q[6]), q[0]),
                           sub_rn(add_rn(q[4], q[7]), q[1]),
                           sub_rn(add_rn(q[5], q[8]), q[2])),
                m) > 0.f;
  return isfinite(s) & (no_det | no_u | no_v | no_sum);
}

__device__ __forceinline__ void load_tri(float* q, const float* __restrict__ soa,
                                         int f, int k) {
#pragma unroll
  for (int row = 0; row < 10; ++row) q[row] = soa[row * f + k];
}

__global__ void __launch_bounds__(K1_THREADS)
ray_pinhole_kernel(const float* __restrict__ dirs, int n_rays, int width,
                   const float* __restrict__ soa, int f,
                   const int* __restrict__ n_tris_p, int count_stride,
                   float t_min, float t_max, float* __restrict__ t_out,
                   int* __restrict__ cnt_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[3 * (K1_TILE + 1)];
  __shared__ int tile_idx[K1_TILE];
  __shared__ float box_part[K1_WARPS][6];
  __shared__ int warp_kept[K1_WARPS];
  const size_t frame = blockIdx.y;
  dirs += frame * n_rays * 3;
  soa += frame * 10 * f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The block's rays. A thread past the frame's edge casts its tile's
  // nearest ray (a ray of the tile: the box is not widened) and writes
  // nothing.
  const int tiles_x = (width + K1_TW - 1) / K1_TW;
  const int height = n_rays / width;
  const int row = (blockIdx.x / tiles_x) * K1_TH + threadIdx.x / K1_TW;
  const int col = (blockIdx.x % tiles_x) * K1_TW + threadIdx.x % K1_TW;
  const int r = row < height && col < width ? row * width + col : -1;
  const int rc = min(row, height - 1) * width + min(col, width - 1);
  const float dx = dirs[3 * rc], dy = dirs[3 * rc + 1], dz = dirs[3 * rc + 2];

  // The ray box (fminf and fmaxf pass over a NaN component).
  float e[6] = {dx, dy, dz, dx, dy, dz};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[c] = fminf(e[c], __shfl_xor_sync(0xffffffffu, e[c], off));
      e[3 + c] = fmaxf(e[3 + c], __shfl_xor_sync(0xffffffffu, e[3 + c], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) box_part[warp][c] = e[c];
  }
  __syncthreads();
  RayBox bx;
  bool box_ok = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float lo = box_part[0][c], hi = box_part[0][3 + c];
#pragma unroll
    for (int w = 1; w < K1_WARPS; ++w) {
      lo = fminf(lo, box_part[w][c]);
      hi = fmaxf(hi, box_part[w][3 + c]);
    }
    bx.lo[c] = lo;
    bx.hi[c] = hi;
    bx.mag[c] = fmaxf(fabsf(lo), fabsf(hi));
    box_ok = box_ok & isfinite(lo) & isfinite(hi);
  }

  float t_best = NBP_INF;
  int cnt = 0, best = -1;
  const int n_tris = clamp_count(n_tris_p + frame * count_stride, f);
  int kept = 0;  // survivors in the tile, the same in every thread
  float q[10];
  if (threadIdx.x < n_tris) load_tri(q, soa, f, threadIdx.x);
  for (int base = 0; base < n_tris; base += K1_THREADS) {
    const int k = base + threadIdx.x;
    float qn[10];
    if (k + K1_THREADS < n_tris) load_tri(qn, soa, f, k + K1_THREADS);
    bool keep = false;
    if (k < n_tris) {
      const float sg = q[9] > 0.f ? 1.f : (q[9] < 0.f ? -1.f : 0.f);
#pragma unroll
      for (int row = 0; row < 6; ++row) q[row] = mul_rn(q[row], -sg);
#pragma unroll
      for (int row = 6; row < 9; ++row) q[row] = mul_rn(q[row], sg);
      keep = !(box_ok && culled(bx, q));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int slot = kept + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) {
      const int c = warp_kept[w];
      slot += w < warp ? c : 0;
      kept += c;
    }
    if (keep) {
      tile[3 * slot] = make_float4(q[0], q[1], q[2], q[3]);
      tile[3 * slot + 1] = make_float4(q[4], q[5], q[6], q[7]);
      tile[3 * slot + 2] = make_float4(q[8], fabsf(q[9]), 0.f, 0.f);
      tile_idx[slot] = k;
    }
    __syncthreads();
    if (kept > K1_TILE - K1_THREADS || base + K1_THREADS >= n_tris) {
      // Folded n = (a.x, a.y, a.z), m2 = (a.w, b.x, b.y), m1 = (b.z, b.w,
      // c.x), |t_num| = c.y. The next survivor is read while this one is
      // tested (the tile has a spare slot for the read past the last). The
      // next round's first barrier keeps the tile until all are done.
      float4 na = tile[0], nb = tile[1], nc = tile[2];
      for (int j = 0; j < kept; ++j) {
        const float4 a = na, b = nb, c = nc;
        na = tile[3 * j + 3];
        nb = tile[3 * j + 4];
        nc = tile[3 * j + 5];
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
              best = tile_idx[j];
            }
          }
        }
      }
      kept = 0;
    }
#pragma unroll
    for (int row = 0; row < 10; ++row) q[row] = qn[row];
  }
  if (r >= 0) {
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
// Each frame is a row-major image width rays wide, cast in 8 x 16 pixel
// tiles. Refuses (cudaErrorInvalidValue) a negative t_min, which the fold
// forbids, a stride other than 0 or 1, and a width that is not positive or
// does not divide n_rays.
extern "C" int nbp_ray_hits_pinhole(const void* dirs, int n_frames,
                                    int n_rays, int width, const void* soa,
                                    int f, const void* n_tris,
                                    int count_stride, float t_min,
                                    float t_max, void* t_out, void* cnt_out,
                                    void* idx_out, void* stream) {
  if (!(t_min >= 0.f) || count_stride < 0 || count_stride > 1 || width < 1 ||
      n_rays % width != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays > 0 && n_frames > 0) {
    const dim3 grid(((width + K1_TW - 1) / K1_TW) *
                        ((n_rays / width + K1_TH - 1) / K1_TH),
                    n_frames);
    ray_pinhole_kernel<<<grid, K1_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)dirs, n_rays, width, (const float*)soa, f,
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
