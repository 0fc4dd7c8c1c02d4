// Planner kernels of the port: the lattice distance field and the path walk.
//
// Neither has a Pallas counterpart: the JAX package runs both as XLA
// while_loops inside its scan rollout (nextbestpath_tpu/planning/
// grid_paths.py:102 bfs_distance_field, :160 extract_path). The port's
// planner runs them on the card so that a pose's plan needs no host sync:
// their plain versions (planning/grid_paths.py) sync on a change test every
// few sweeps and walk the path on the host.
//
// nbp_bfs_field: unit-cost distances from the start over a 4-connected
// L x H lattice whose edges may be blocked (blocked[d, i, j]: the edge
// (i, j) -> (i, j) + DIRS[d]). One block holds the lattice in shared memory
// (int32 distances and the incoming-edge flags, 8 bytes a node, 32 KB at
// the 4,096-node limit) and relaxes every node against its four
// predecessors, sweep after sweep, until a sweep changes nothing
// (__syncthreads_or) or L*H sweeps have run, as the JAX loop's cap is. A node
// is written only by its own thread, and a relaxation only ever lowers a
// distance to another upper bound of the true one, so reading a neighbour
// mid-sweep, old or new, converges to the same fixpoint: the exact BFS
// distances, INF (2^20) where unreachable. The result is integer-exact and
// equals the plain version's whatever the order of the threads.
//
// nbp_extract_path: the walk from the goal back to the start along
// decreasing distances, the first predecessor in DIRS order taken, into a
// circular buffer of max_len nodes, so that when the goal lies further than
// max_len the nodes nearest the start are kept (JAX :160-238). The block
// stages the distances and the edge flags in shared memory; one thread
// walks (the walk is sequential: each step depends on the node before), and
// the block writes the path out.
//
// What bounds them on an H100: latency. A 17 x 17 lattice is 289 nodes; a
// sweep is about 16 integer operations a node and the field needs about as
// many sweeps as the start's eccentricity, some 10^5 operations, under a
// microsecond at the card's integer rate. The walk is tens of dependent
// steps. Both take about a launch's time; the gain is that the plan branch
// stays on the device, replayed in a CUDA graph.
#include "common.cuh"

constexpr int PLAN_MAX_NODES = 4096;
constexpr int PLAN_MAX_PATH = 1024;
constexpr int BFS_THREADS = 1024;
constexpr int PATH_THREADS = 256;
constexpr int PLAN_INF = 1 << 20;

__constant__ int DIR_L[4] = {1, -1, 0, 0};
__constant__ int DIR_H[4] = {0, 0, 1, -1};

__global__ void __launch_bounds__(BFS_THREADS)
bfs_field_kernel(const unsigned char* __restrict__ blocked,
                 const long long* __restrict__ start, int L, int H,
                 int* __restrict__ dist_out) {
  __shared__ int dist[PLAN_MAX_NODES];
  // in_ok[c]: bit d set when node c may be entered from c - DIRS[d].
  __shared__ unsigned char in_ok[PLAN_MAX_NODES];
  const int n = L * H;
  const long long s0 = start[0], s1 = start[1];
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int i = c / H, j = c - (c / H) * H;
    dist[c] = (i == s0 && j == s1) ? 0 : PLAN_INF;
    unsigned char ok = 0;
    for (int d = 0; d < 4; ++d) {
      const int pi = i - DIR_L[d], pj = j - DIR_H[d];
      if (pi >= 0 && pi < L && pj >= 0 && pj < H &&
          !blocked[d * n + pi * H + pj])
        ok |= (unsigned char)(1 << d);
    }
    in_ok[c] = ok;
  }
  __syncthreads();
  for (int sweep = 0; sweep < n; ++sweep) {
    int changed = 0;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int ok = in_ok[c];
      const int old = dist[c];
      int best = old;
      for (int d = 0; d < 4; ++d) {
        if (ok & (1 << d)) {
          const int cand = dist[c - (DIR_L[d] * H + DIR_H[d])] + 1;
          best = cand < best ? cand : best;
        }
      }
      if (best < old) {
        dist[c] = best;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) dist_out[c] = dist[c];
}

__global__ void __launch_bounds__(PATH_THREADS)
extract_path_kernel(const int* __restrict__ dist_in,
                    const unsigned char* __restrict__ blocked,
                    const long long* __restrict__ goal, int L, int H,
                    int max_len, int* __restrict__ path,
                    int* __restrict__ meta) {
  __shared__ int dist[PLAN_MAX_NODES];
  __shared__ unsigned char blk[4 * PLAN_MAX_NODES];
  __shared__ int rev[PLAN_MAX_PATH][2];
  __shared__ int s_gd, s_len;
  const int n = L * H;
  for (int c = threadIdx.x; c < n; c += blockDim.x) dist[c] = dist_in[c];
  for (int c = threadIdx.x; c < 4 * n; c += blockDim.x) blk[c] = blocked[c];
  for (int k = threadIdx.x; k < max_len; k += blockDim.x) {
    rev[k][0] = -1;
    rev[k][1] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The goal is clamped into the lattice, as the JAX gather clamps.
    long long gl = goal[0], gh = goal[1];
    gl = gl < 0 ? 0 : (gl >= L ? L - 1 : gl);
    gh = gh < 0 ? 0 : (gh >= H ? H - 1 : gh);
    const int goal_dist = dist[gl * H + gh];
    const bool reachable = goal_dist < PLAN_INF;
    const int limit = reachable ? goal_dist : 0;
    int nl = (int)gl, nh = (int)gh, d = goal_dist;
    for (int it = 0; it < limit; ++it) {
      const int slot = it % max_len;
      rev[slot][0] = nl;
      rev[slot][1] = nh;
      if (d > 0) {
        for (int k = 0; k < 4; ++k) {
          const int pl = nl - DIR_L[k], ph = nh - DIR_H[k];
          if (pl < 0 || pl >= L || ph < 0 || ph >= H) continue;
          if (!blk[k * n + pl * H + ph] && dist[pl * H + ph] == d - 1) {
            nl = pl;
            nh = ph;
            break;
          }
        }
      }
      d = d > 0 ? d - 1 : 0;
    }
    s_gd = reachable ? goal_dist : 1;
    s_len = goal_dist < max_len ? goal_dist : max_len;
    meta[0] = s_len;
    meta[1] = reachable ? 1 : 0;
  }
  __syncthreads();
  const int gd = s_gd, len = s_len;
  for (int j = threadIdx.x; j < max_len; j += blockDim.x) {
    int r = (gd - 1 - j) % max_len;
    r = r < 0 ? r + max_len : r;
    path[2 * j] = j < len ? rev[r][0] : -1;
    path[2 * j + 1] = j < len ? rev[r][1] : -1;
  }
}

// The limits, for the launchers in kernels.py to read and name in their
// refusal: out[0] = PLAN_MAX_NODES, out[1] = PLAN_MAX_PATH.
extern "C" void nbp_plan_limits(int* out) {
  out[0] = PLAN_MAX_NODES;
  out[1] = PLAN_MAX_PATH;
}

// Both refuse (cudaErrorInvalidValue) a lattice past PLAN_MAX_NODES nodes
// or a path buffer past PLAN_MAX_PATH.
extern "C" int nbp_bfs_field(const void* blocked, const void* start, int L,
                             int H, void* dist, void* stream) {
  if (L <= 0 || H <= 0 || L * H > PLAN_MAX_NODES)
    return (int)cudaErrorInvalidValue;
  bfs_field_kernel<<<1, BFS_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)blocked, (const long long*)start, L, H,
      (int*)dist);
  return (int)cudaGetLastError();
}

extern "C" int nbp_extract_path(const void* dist, const void* blocked,
                                const void* goal, int L, int H, int max_len,
                                void* path, void* meta, void* stream) {
  if (L <= 0 || H <= 0 || L * H > PLAN_MAX_NODES || max_len <= 0 ||
      max_len > PLAN_MAX_PATH)
    return (int)cudaErrorInvalidValue;
  extract_path_kernel<<<1, PATH_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)dist, (const unsigned char*)blocked,
      (const long long*)goal, L, H, max_len, (int*)path, (int*)meta);
  return (int)cudaGetLastError();
}
