// The Gumbel-max token draw of the port's next-best-view gain: the noise
// (G1) and every candidate's masked argmax (G2).
//
// Neither replaces a Pallas kernel. The JAX package draws a candidate's
// tokens with jax.random.categorical (nextbestpath_tpu/sim/coverage_gain.py
// sample_proxy_points), which XLA fuses; the port's eager chain was six
// passes over the noise to make it (rand, clamp, log, neg, log, neg) and,
// for each of the C candidates, an add and an argmax over it: at 20
// candidates of 2,048 tokens over 20,000 proxy points, 3.28 GB of noise a
// pose written and read some ten times, 16 device ms on an H100.
//
// What bounds them on an H100: bytes. The draw must write the noise once
// (the caller keeps it: the draws are served as tensors) and read it once,
// 3.28 GB each way, about 1 ms each at 3.35 TB/s. G1 also spends some 60
// instructions an element (a quarter of a Philox4x32-10 call and two
// precise logf), about as long again, overlapped with its stores.
//
// nbp_gumbel_noise (G1): standard Gumbel noise -log(-log(max(u, tiny))),
// u the bits torch.rand serves from the same CUDA generator. torch.rand
// (ATen/native/cuda/DistributionTemplates.h, distribution_nullary_kernel
// with uniform_kernel's transform) launches 256-thread blocks on a grid of
// min(SMs x threads an SM / 256, ceil(n / 256)); thread idx draws
// curand_uniform4 from curand_init(seed, idx, offset) once a trip of a
// grid-stride loop unrolled by 4, element idx + stride * (4 k + i) taking
// component i of trip k, and a 1 becomes 0. It advances the generator by
// 4 counters a trip of that loop. The wrapper (kernels.rand_policy) makes
// that grid and those offsets, one a shape as consecutive torch.rand calls
// would take them, and moves the generator on by their sum; this kernel
// replays the stream for every shape of the call in one launch (blockIdx.y
// the shape) and applies the transform in registers, with IEEE logf (no
// fast math, as torch.log), so each element is the eager chain's bits and
// one write. The stores are one float a lane, the warp's 32 on
// consecutive addresses.
//
// nbp_gumbel_argmax (G2): tokens[c, r] = argmax_j (noise_c[r, j] +
// logits[c, j]), ties to the smaller j and NaN above every number, as
// torch.argmax(noise + logits, -1) gives them. The C noise tensors are read
// where they lie (an array of pointers, no stack). A block stages one
// candidate's logits (P floats, 80 KB at P = 20,000) in shared memory and
// takes a contiguous range of that candidate's rows; a warp takes a row at
// a time and reads it once, 16 bytes a lane (four loads in flight a lane),
// each score rounded as one f32 add (add_rn), a lane's running (max,
// index) in registers, then a five-step shuffle reduction. Rows whose
// width or base is no multiple of 16 bytes take one float a lane. The grid
// is one wave: the blocks the card holds at once (occupancy API), split
// evenly over the candidates, so no block waits for a second wave.
#include <curand_kernel.h>

#include <algorithm>

#include "common.cuh"

constexpr int G1_THREADS = 256;     // torch's block_size_bound
constexpr int G1_UNROLL = 4;        // curand_uniform4's floats a call
constexpr int G1_MAX_SHAPES = 64;   // shapes a launch (the kernel's argument)
constexpr int G2_THREADS = 512;
constexpr int G2_WARPS = G2_THREADS / 32;
constexpr int G2_MAX_CANDS = 64;    // candidates a launch
constexpr int G2_MAX_P = 57344;     // floats of logits in shared memory (224 KB)

struct GumbelShapes {
  float* out[G1_MAX_SHAPES];
  long long n[G1_MAX_SHAPES];
  unsigned long long offset[G1_MAX_SHAPES];
  int grid[G1_MAX_SHAPES];
};

struct NoiseRows {
  const float* noise[G2_MAX_CANDS];
};

// torch.rand's u (a 1 folded to 0), clamped to the smallest normal float,
// then -log(-log(u)), each op rounded as the eager chain rounds it.
__device__ __forceinline__ float gumbel_of(float u) {
  u = u == 1.0f ? 0.0f : u;
  u = fmaxf(u, __int_as_float(0x00800000));
  return -logf(-logf(u));
}

__global__ void __launch_bounds__(G1_THREADS, 4)
gumbel_noise_kernel(GumbelShapes sh, unsigned long long seed) {
  const int s = blockIdx.y;
  const int grid = sh.grid[s];
  if ((int)blockIdx.x >= grid) return;
  const long long n = sh.n[s];
  float* out = sh.out[s];
  const long long idx = (long long)blockIdx.x * G1_THREADS + threadIdx.x;
  curandStatePhilox4_32_10_t state;
  curand_init(seed, idx, sh.offset[s], &state);
  const long long stride = (long long)grid * G1_THREADS;
  const long long trip = stride * G1_UNROLL;
  const long long rounded = ((n - 1) / trip + 1) * trip;
  for (long long li = idx; li < rounded; li += trip) {
    const float4 r = curand_uniform4(&state);
    const float u[G1_UNROLL] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < G1_UNROLL; ++k) {
      const long long i = li + stride * k;
      if (i < n) out[i] = gumbel_of(u[k]);
    }
  }
}

// Whether score a at index ia wins over b at ib as torch.argmax picks: NaN
// above every number, then the larger, ties to the smaller index; an index
// below 0 holds no element.
__device__ __forceinline__ bool argmax_wins(float a, int ia, float b, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// A lane's running argmax over increasing indices: a later index wins only
// by a larger score (or the first NaN).
__device__ __forceinline__ void take(float s, int j, float& best, int& bi) {
  if (bi < 0 || s > best || (s != s && best == best)) {
    best = s;
    bi = j;
  }
}

__device__ __forceinline__ void take4(float4 a, float4 l, int q, float& best,
                                      int& bi) {
  take(add_rn(a.x, l.x), 4 * q, best, bi);
  take(add_rn(a.y, l.y), 4 * q + 1, best, bi);
  take(add_rn(a.z, l.z), 4 * q + 2, best, bi);
  take(add_rn(a.w, l.w), 4 * q + 3, best, bi);
}

__global__ void __launch_bounds__(G2_THREADS)
gumbel_argmax_kernel(NoiseRows nz, const float* __restrict__ logits, int n,
                     int P, int rows_per_block, int vec,
                     long long* __restrict__ out) {
  extern __shared__ float4 lg4[];
  float* lg = reinterpret_cast<float*>(lg4);
  const int c = blockIdx.y;
  const float* lc = logits + (size_t)c * P;
  for (int j = threadIdx.x; j < P; j += G2_THREADS) lg[j] = lc[j];
  __syncthreads();
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* base = nz.noise[c];
  for (int r = r0 + warp; r < r1; r += G2_WARPS) {
    const float* row = base + (size_t)r * P;
    float best = 0.0f;
    int bi = -1;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      const int p4 = P >> 2;
      int q = lane;
      for (; q + 96 < p4; q += 128) {
        const float4 a0 = __ldcs(row4 + q), a1 = __ldcs(row4 + q + 32);
        const float4 a2 = __ldcs(row4 + q + 64), a3 = __ldcs(row4 + q + 96);
        take4(a0, lg4[q], q, best, bi);
        take4(a1, lg4[q + 32], q + 32, best, bi);
        take4(a2, lg4[q + 64], q + 64, best, bi);
        take4(a3, lg4[q + 96], q + 96, best, bi);
      }
      for (; q < p4; q += 32) take4(__ldcs(row4 + q), lg4[q], q, best, bi);
    } else {
      for (int j = lane; j < P; j += 32)
        take(add_rn(__ldcs(row + j), lg[j]), j, best, bi);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, m);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
      if (argmax_wins(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) out[(size_t)c * n + r] = bi;
  }
}

extern "C" void nbp_gumbel_limits(int* out) {
  out[0] = G1_MAX_SHAPES;
  out[1] = G2_MAX_CANDS;
  out[2] = G2_MAX_P;
}

// n_shapes shapes: outs (device pointers), ns (elements), offsets (Philox
// counters) and grids (blocks) host arrays, one entry a shape; seed the
// generator's. Refuses (cudaErrorInvalidValue) more than G1_MAX_SHAPES
// shapes, an empty one, a grid outside [1, 65535 x 32768].
extern "C" int nbp_gumbel_noise(void* const* outs, const long long* ns,
                                const unsigned long long* offsets,
                                const int* grids, int n_shapes,
                                unsigned long long seed, void* stream) {
  if (n_shapes < 1 || n_shapes > G1_MAX_SHAPES)
    return (int)cudaErrorInvalidValue;
  GumbelShapes sh;
  int grid_x = 1;
  for (int s = 0; s < n_shapes; ++s) {
    if (ns[s] < 1 || grids[s] < 1) return (int)cudaErrorInvalidValue;
    sh.out[s] = (float*)outs[s];
    sh.n[s] = ns[s];
    sh.offset[s] = offsets[s];
    sh.grid[s] = grids[s];
    grid_x = std::max(grid_x, grids[s]);
  }
  gumbel_noise_kernel<<<dim3(grid_x, n_shapes), G1_THREADS, 0,
                        (cudaStream_t)stream>>>(sh, seed);
  return (int)cudaGetLastError();
}

// n_c candidates: noise (n_c device pointers, each (n, P) f32 row-major),
// logits (n_c, P) f32 -> out (n_c, n) int64. vec: every row's base is 16-
// byte aligned and P a multiple of 4. Refuses (cudaErrorInvalidValue) more
// than G2_MAX_CANDS candidates or P outside [1, G2_MAX_P].
extern "C" int nbp_gumbel_argmax(const void* const* noise, int n_c,
                                 const void* logits, int n, int P, int vec,
                                 void* out, void* stream) {
  if (n_c < 1 || n_c > G2_MAX_CANDS || P < 1 || P > G2_MAX_P || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int smem = P * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gumbel_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gumbel_argmax_kernel,
                                                G2_THREADS, smem);
  const int resident = std::max(1, per_sm) * sm_count();
  const int per_cand = std::max(1, std::min(resident / n_c, n));
  const int rows = (n + per_cand - 1) / per_cand;
  NoiseRows nz;
  for (int c = 0; c < n_c; ++c) nz.noise[c] = (const float*)noise[c];
  gumbel_argmax_kernel<<<dim3((n + rows - 1) / rows, n_c), G2_THREADS, smem,
                         (cudaStream_t)stream>>>(
      nz, (const float*)logits, n, P, rows, vec, (long long*)out);
  return (int)cudaGetLastError();
}
