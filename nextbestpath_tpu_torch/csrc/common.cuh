// Shared helpers of the port's kernels.
//
// Every product and sum goes through the round-to-nearest intrinsics so that
// nvcc never contracts a multiply and an add into one FMA. The kernels then
// round exactly as the plain PyTorch versions beside them do (one rounding per
// elementwise op, sums in index order), and a hit or miss at a triangle's
// edge is decided by the same bits on both. Division is IEEE (no fast math).
#pragma once
#include <cuda_runtime.h>

#define NBP_INF 3.4e38f
#define NBP_DET_EPS 1e-10f

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// (a0*b0 + a1*b1) + a2*b2, each op rounded.
__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// A count read from device memory, clamped to [0, hi].
__device__ __forceinline__ int clamp_count(const int* p, int hi) {
  int n = *p;
  return n < 0 ? 0 : (n > hi ? hi : n);
}

// The current device's SM count, read on the host (no sync).
static inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}
