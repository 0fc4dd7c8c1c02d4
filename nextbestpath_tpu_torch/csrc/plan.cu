// Planner kernels of the port: the lattice distance field and the path walk.
//
// Neither has a Pallas counterpart: the JAX package runs both as XLA
// while_loops inside its scan rollout (nextbestpath_tpu/planning/
// grid_paths.py:102 bfs_distance_field, :160 extract_path). The port's
// planner runs them on the card so that a pose's plan needs no host sync:
// their plain versions (planning/grid_paths.py) sync on a change test every
// few sweeps and walk the path on the host.
//
// What bounds them: a dependent chain, not bytes or operations. The field
// needs one BFS level after another, as many as the start's eccentricity
// (34 on the 17x17 main path, 115 on the procgen insane/8 lattice, 3,363
// on a 58x58 serpentine maze); the walk needs one step after another, as
// many as the goal's distance. A level or a step is a few integer
// operations, so each design shortens one link of the chain and keeps the
// rest of the work off it.
//
// nbp_bfs_field: unit-cost distances from the start over a 4-connected
// L x H lattice whose edges may be blocked (blocked[d, i, j]: the edge
// (i, j) -> (i, j) + DIRS[d], DIRS = (+l, -l, +h, -h)). A level-synchronous
// BFS on bit masks, one warp a scene. The lattice is laid out as R rows of
// W bits (W <= 64): the longer axis in the word when it fits in 64 bits,
// else the shorter one, which then fits since L * H <= 4,096; a row is a
// 32-bit word when W <= 32, else a 64-bit one. A lane holds its RPL rows'
// frontier F, visited mask V and four "may be entered from" masks, one for
// each way a row is reached: from the row before, the row after, the bit
// below (F << 1) and the bit above (F >> 1), each the direction DIRS[d]
// that moves that way with its edge flag read at the source. The masks are
// built from the edge flags staged in shared memory by coalesced loads
// (read from device memory, a lane its own rows, they were slower). One
// level is
//     N = (prev(F) & ok_prev) | (next(F) & ok_next)
//       | ((F << 1) & ok_shl) | ((F >> 1) & ok_shr);   N &= ~V;  V |= N
// with prev/next one __shfl_up_sync/__shfl_down_sync across lanes, then the
// level written into the shared-memory field for the bits of N (__ffs), and
// the loop ends when __any_sync finds every N empty, asked every second
// level (a level after an empty one is empty). There is no block barrier
// in the loop: a level is two shuffles, some twenty logic operations on
// 32-bit halves, the writes and half a vote. The writes, a loop over each
// row word's bits, cost about as much again as the rest of the level on
// the maze, where a level has one node; a ring of 16 levels' words written
// out together, and predicated stores of each word's first two bits with a
// vote for the rest, were both slower on the H100. Each scene has its own
// warp, several scenes a block, and the field goes out coalesced at the
// end. Lattices of more than 128 rows (long and thin: 4,096 x 1) take a
// block a scene instead, one row a thread, the frontier in shared memory
// and one __syncthreads_or a level. The BFS levels are the exact
// distances, the fixpoint the JAX loop's relaxation sweeps reach within
// their L*H cap, so the field equals the plain version's: INF (2^20) where
// unreachable, all INF when the start lies off the lattice.
//
// nbp_extract_path: the walk from the goal back to the start along
// decreasing distances, the first predecessor in DIRS order taken (JAX
// :160-238). The block first computes, for every node c at once, the
// predecessor the walk takes at c when its counter equals dist[c] (the four
// candidates' flags and distances loaded together), and packs it with
// dist[c] into one 32-bit word: the predecessor's index in the top 12 bits
// (c itself when it has none), dist[c] in the low 20 (0, which the counter
// never is, where dist[c] is not in [1, INF)). One thread then chases from
// the goal with its counter d = goal_dist - it: one dependent shared-memory
// load a step, whether each word's distance was its counter gathered on
// the side, the steps past max_len in a loop of their own that writes no
// slot. On a BFS field of the same edges every word matches; where one did
// not, the walk is taken again by the exact rule from the inputs, each step
// checked, so the kernel equals the plain version on every input. A goal
// off the lattice is taken as JAX takes it: its distance read where a JAX
// gather reads (a negative index from the end, then clamped), the walk
// begun at the goal itself, by the exact rule until it steps onto the
// lattice. The node at counter d is the path's slot d - 1 (the slot the JAX
// circular buffer leaves there), written only for d <= max_len; slots at
// or past min(goal_dist, max_len) are -1. meta is the length
// min(goal_dist, max_len) and whether the goal is reachable.
//
// Both take an optional device flag a scene (null for callers that have
// none). Where it is set the kernel writes a defined result at once and
// returns: the field all INF; the path all -1, length 0, unreachable. The
// scan's planning attempts pass their "done" flags, so an attempt after
// the one that found a path costs a launch and no chain.
//
// The scene axis (the JAX package vmaps its batched plan over scenes):
// blocked (B, 4, L, H), start or goal (B, 2), skip (B,), dist (B, L, H),
// path (B, max_len, 2), meta (B, 2). The limits hold for each scene; a
// single scene is B = 1.
#include "common.cuh"

constexpr int PLAN_MAX_NODES = 4096;
constexpr int PLAN_MAX_PATH = 1024;
constexpr int PLAN_INF = 1 << 20;
constexpr int WARP = 32;
constexpr int BFS_MAX_RPL = 4;                   // one warp: up to 128 rows
constexpr int BFS_WARP_ROWS = WARP * BFS_MAX_RPL;
constexpr int BFS_MAX_WARPS = 8;                 // scenes a block
constexpr int BFS_SHARED_BYTES = 48 * 1024;      // the fields of a block
constexpr int BFS_WIDE_THREADS = 1024;
constexpr int BFS_WIDE_RPT = PLAN_MAX_NODES / BFS_WIDE_THREADS;
constexpr int PATH_THREADS = 256;
constexpr int PATH_DIST_BITS = 20;
constexpr unsigned PATH_DIST_MASK = (1u << PATH_DIST_BITS) - 1;
constexpr unsigned FULL_MASK = 0xffffffffu;

typedef unsigned long long u64;

__constant__ int DIR_L[4] = {1, -1, 0, 0};
__constant__ int DIR_H[4] = {0, 0, 1, -1};

// The row and bit layout of an L x H lattice.
struct RowLayout {
  int L, H, R, W;
  bool swap;  // rows along h and bits along l (else rows along l)
  __device__ int node(int r, int b) const { return swap ? b * H + r : r * H + b; }
};

static RowLayout row_layout(int L, int H) {
  RowLayout g;
  g.L = L;
  g.H = H;
  // The longer axis in the word when it fits, else the shorter one.
  const bool bits_on_longer = (L > H ? L : H) <= 64;
  g.swap = bits_on_longer ? (L > H) : (L < H);
  g.R = g.swap ? H : L;
  g.W = g.swap ? L : H;
  return g;
}

// The mask of row r's bits that may be entered by kind q of move (0 from
// row r - 1, 1 from row r + 1, 2 from bit b - 1, 3 from bit b + 1): the
// source lies on the lattice and its edge in the direction that moves so
// is open. blocked is the scene's (4, L, H) flags, in device or shared
// memory.
__device__ u64 entry_mask(const unsigned char* __restrict__ blocked,
                          const RowLayout& g, int r, int q) {
  const int dr = q == 0 ? 1 : (q == 1 ? -1 : 0);
  const int db = q == 2 ? 1 : (q == 3 ? -1 : 0);
  // In the swapped layout a row step is an h step (DIRS 2, 3) and a bit
  // step an l step (DIRS 0, 1).
  const int d = g.swap ? (q ^ 2) : q;
  const int sr = r - dr;
  if (sr < 0 || sr >= g.R) return 0;
  // Source bit sb of row sr lies at src[row0 + sb * step]. Every load is
  // made (a source off the row reads bit b's own flag and is dropped), so
  // that the loads of the unrolled loop go out together.
  const unsigned char* __restrict__ src = blocked + d * g.L * g.H;
  const int row0 = g.swap ? sr : sr * g.H, step = g.swap ? g.H : 1;
  u64 m = 0;
#pragma unroll 8
  for (int b = 0; b < g.W; ++b) {
    const int sb = b - db;
    const bool on = sb >= 0 && sb < g.W;
    const unsigned char flag = src[row0 + (on ? sb : b) * step];
    m |= (u64)(on && !flag) << b;
  }
  return m;
}

__device__ __forceinline__ bool start_on_lattice(long long s0, long long s1,
                                                 int L, int H) {
  return s0 >= 0 && s0 < L && s1 >= 0 && s1 < H;
}

__device__ __forceinline__ int lowest_bit(unsigned m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int lowest_bit(u64 m) { return __ffsll((long long)m) - 1; }

// One warp a scene, RPL rows a lane (rows lane*RPL .. lane*RPL + RPL - 1),
// a row a Word (32 bits when W <= 32, else 64). The scene's edge flags are
// first staged into the warp's field in shared memory (4n bytes, the
// field's own size) with coalesced loads, the masks built from there, and
// only then is the field set to INF. A level writes its nodes' distances
// as it goes, a loop over the bits of each row word.
template <typename Word, int RPL>
__global__ void __launch_bounds__(WARP * BFS_MAX_WARPS)
bfs_warp_kernel(const unsigned char* __restrict__ blocked,
                const long long* __restrict__ start,
                const bool* __restrict__ skip, int n_b, RowLayout g,
                int* __restrict__ dist_out) {
  extern __shared__ __align__(16) int s_field[];
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const int scene = blockIdx.x * (blockDim.x / WARP) + warp;
  if (scene >= n_b) return;
  const int n = g.L * g.H;
  // The staged edge flags, then the field; 16-byte aligned.
  int* dist = s_field + warp * ((n + 3) & ~3);
  blocked += (size_t)scene * 4 * n;
  dist_out += (size_t)scene * n;
  const long long s0 = start[2 * scene], s1 = start[2 * scene + 1];
  if ((skip != nullptr && skip[scene]) || !start_on_lattice(s0, s1, g.L, g.H)) {
    for (int c = lane; c < n; c += WARP) dist_out[c] = PLAN_INF;
    return;
  }
  unsigned char* s_blk = reinterpret_cast<unsigned char*>(dist);
  if ((reinterpret_cast<size_t>(blocked) & 15) == 0 && (n & 3) == 0) {
    const uint4* __restrict__ src = reinterpret_cast<const uint4*>(blocked);
    uint4* dst = reinterpret_cast<uint4*>(dist);
#pragma unroll 4
    for (int c = lane; c < n / 4; c += WARP) dst[c] = __ldg(src + c);
  } else {
    for (int c = lane; c < 4 * n; c += WARP) s_blk[c] = blocked[c];
  }
  __syncwarp();
  const int s_row = g.swap ? (int)s1 : (int)s0;
  const int s_bit = g.swap ? (int)s0 : (int)s1;
  Word ok_prev[RPL], ok_next[RPL], ok_shl[RPL], ok_shr[RPL], F[RPL], V[RPL];
  int base[RPL];
  const int stride = g.swap ? g.H : 1;
#pragma unroll
  for (int k = 0; k < RPL; ++k) {
    const int r = lane * RPL + k;
    const bool row = r < g.R;
    ok_prev[k] = row ? (Word)entry_mask(s_blk, g, r, 0) : 0;
    ok_next[k] = row ? (Word)entry_mask(s_blk, g, r, 1) : 0;
    ok_shl[k] = row ? (Word)entry_mask(s_blk, g, r, 2) : 0;
    ok_shr[k] = row ? (Word)entry_mask(s_blk, g, r, 3) : 0;
    F[k] = V[k] = r == s_row ? (Word)1 << s_bit : 0;
    base[k] = g.swap ? r : r * g.H;
  }
  __syncwarp();
#pragma unroll 4
  for (int c = lane; c < n; c += WARP) dist[c] = PLAN_INF;
  __syncwarp();
  if (lane == 0) dist[g.node(s_row, s_bit)] = 0;
  // One level: the next frontier from F, F and V moved on, its nodes'
  // distances written. Lane 0's row before and lane 31's row after are off
  // the lattice or padding; their masks are 0, so what the shuffles bring
  // there is dropped.
  auto level = [&](int lv) {
    const Word up = __shfl_up_sync(FULL_MASK, F[RPL - 1], 1);
    const Word down = __shfl_down_sync(FULL_MASK, F[0], 1);
    Word N[RPL];
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      const Word prev = k == 0 ? up : F[k - 1];
      const Word next = k == RPL - 1 ? down : F[k + 1];
      N[k] = ((prev & ok_prev[k]) | (next & ok_next[k]) |
              ((F[k] << 1) & ok_shl[k]) | ((F[k] >> 1) & ok_shr[k])) & ~V[k];
    }
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      V[k] |= N[k];
      F[k] = N[k];
      for (Word m = N[k]; m; m &= m - 1) dist[base[k] + lowest_bit(m) * stride] = lv;
    }
  };
  // Two levels a vote: a level after an empty one is empty too.
  for (int lv = 1;; lv += 2) {
    level(lv);
    level(lv + 1);
    bool any = false;
#pragma unroll
    for (int k = 0; k < RPL; ++k) any |= F[k] != 0;
    if (!__any_sync(FULL_MASK, any)) break;
  }
  __syncwarp();
#pragma unroll 4
  for (int c = lane; c < n; c += WARP) dist_out[c] = dist[c];
}

// More than BFS_WARP_ROWS rows (then W <= 31): a block a scene, row
// tid + j * blockDim.x held by thread tid, the frontier in shared memory
// (double-buffered, so one barrier a level), the field written to device
// memory directly.
__global__ void __launch_bounds__(BFS_WIDE_THREADS)
bfs_wide_kernel(const unsigned char* __restrict__ blocked,
                const long long* __restrict__ start,
                const bool* __restrict__ skip, RowLayout g,
                int* __restrict__ dist_out) {
  __shared__ unsigned s_front[2][PLAN_MAX_NODES];
  const int scene = blockIdx.x;
  const int n = g.L * g.H;
  const int T = blockDim.x;
  blocked += (size_t)scene * 4 * n;
  dist_out += (size_t)scene * n;
  const long long s0 = start[2 * scene], s1 = start[2 * scene + 1];
  for (int c = threadIdx.x; c < n; c += T) dist_out[c] = PLAN_INF;
  if ((skip != nullptr && skip[scene]) || !start_on_lattice(s0, s1, g.L, g.H))
    return;
  const int s_row = g.swap ? (int)s1 : (int)s0;
  const int s_bit = g.swap ? (int)s0 : (int)s1;
  unsigned ok_prev[BFS_WIDE_RPT], ok_next[BFS_WIDE_RPT], ok_shl[BFS_WIDE_RPT],
      ok_shr[BFS_WIDE_RPT], V[BFS_WIDE_RPT];
#pragma unroll
  for (int j = 0; j < BFS_WIDE_RPT; ++j) {
    const int r = threadIdx.x + j * T;
    const bool row = r < g.R;
    ok_prev[j] = row ? (unsigned)entry_mask(blocked, g, r, 0) : 0u;
    ok_next[j] = row ? (unsigned)entry_mask(blocked, g, r, 1) : 0u;
    ok_shl[j] = row ? (unsigned)entry_mask(blocked, g, r, 2) : 0u;
    ok_shr[j] = row ? (unsigned)entry_mask(blocked, g, r, 3) : 0u;
    V[j] = r == s_row ? 1u << s_bit : 0u;
    if (row) s_front[0][r] = V[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) dist_out[g.node(s_row, s_bit)] = 0;
  int cur = 0;
  for (int level = 1;; ++level) {
    const unsigned* __restrict__ F = s_front[cur];
    int any = 0;
#pragma unroll
    for (int j = 0; j < BFS_WIDE_RPT; ++j) {
      const int r = threadIdx.x + j * T;
      if (r >= g.R) continue;
      const unsigned f = F[r];
      const unsigned prev = r > 0 ? F[r - 1] : 0u;
      const unsigned next = r + 1 < g.R ? F[r + 1] : 0u;
      const unsigned nx = ((prev & ok_prev[j]) | (next & ok_next[j]) |
                           ((f << 1) & ok_shl[j]) | ((f >> 1) & ok_shr[j])) & ~V[j];
      V[j] |= nx;
      s_front[cur ^ 1][r] = nx;
      any |= nx != 0;
      for (unsigned m = nx; m; m &= m - 1)
        dist_out[g.node(r, __ffs((int)m) - 1)] = level;
    }
    if (!__syncthreads_or(any)) break;
    cur ^= 1;
  }
}

// The exact rule of one step at node (i, j), on the lattice or off it,
// with counter d: the index of the first predecessor in DIRS order on the
// lattice, with its edge open and distance d - 1; else -1 (the walk
// stays). The four candidates' flags and distances are loaded together.
__device__ int walk_pred(const int* __restrict__ dist,
                         const unsigned char* __restrict__ blocked, int L,
                         int H, long long i, long long j, int d) {
  const int n = L * H;
  int p[4], pd[4];
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long pi = i - DIR_L[k], pj = j - DIR_H[k];
    const bool in = pi >= 0 && pi < L && pj >= 0 && pj < H;
    p[k] = in ? (int)(pi * H + pj) : 0;
    pd[k] = dist[p[k]];
    ok[k] = in && !blocked[k * n + p[k]];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (ok[k] && pd[k] == d - 1) return p[k];
  return -1;
}

// A JAX gather's index along an axis of n: negative from the end, then
// clamped.
__device__ __forceinline__ int gather_index(long long i, int n) {
  i = i < 0 ? i + n : i;
  return (int)(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

// The path slot of the goal while the walk stays on it off the lattice.
constexpr int SLOT_RAW_GOAL = -2;

__global__ void __launch_bounds__(PATH_THREADS)
extract_path_kernel(const int* __restrict__ dist_in,
                    const unsigned char* __restrict__ blocked,
                    const long long* __restrict__ goal,
                    const bool* __restrict__ skip, int L, int H, int max_len,
                    int* __restrict__ path, int* __restrict__ meta) {
  __shared__ unsigned s_word[PLAN_MAX_NODES];
  __shared__ int s_slot[PLAN_MAX_PATH];
  __shared__ int s_written;
  const int n = L * H;
  const size_t scene = blockIdx.x;
  dist_in += scene * n;
  blocked += scene * 4 * n;
  goal += scene * 2;
  path += scene * 2 * max_len;
  meta += scene * 2;
  if (skip != nullptr && skip[scene]) {
    for (int k = threadIdx.x; k < 2 * max_len; k += blockDim.x) path[k] = -1;
    if (threadIdx.x == 0) meta[0] = meta[1] = 0;
    return;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int dc = dist_in[c];
    unsigned w = 0;
    if (dc >= 1 && dc < PLAN_INF) {
      const int p = walk_pred(dist_in, blocked, L, H, c / H, c % H, dc);
      w = ((unsigned)(p < 0 ? c : p) << PATH_DIST_BITS) | (unsigned)dc;
    }
    s_word[c] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The goal's distance is read where the JAX gather reads; the walk
    // starts at the goal itself (JAX :173-236), which it leaves only for a
    // predecessor on the lattice.
    const long long gl = goal[0], gh = goal[1];
    const int goal_dist = dist_in[gather_index(gl, L) * H + gather_index(gh, H)];
    const bool reachable = goal_dist < PLAN_INF;
    const int len = goal_dist < max_len ? goal_dist : max_len;
    int d = reachable ? goal_dist : 0;
    int c = gl >= 0 && gl < L && gh >= 0 && gh < H ? (int)(gl * H + gh) : -1;
    for (; c < 0 && d >= 1; --d) {
      if (d <= max_len) s_slot[d - 1] = SLOT_RAW_GOAL;
      c = walk_pred(dist_in, blocked, L, H, gl, gh, d);
    }
    // The chase: one dependent load a step; whether each word's distance
    // was its counter is gathered on the side. On a BFS field of these
    // edges it always is; where not, the walk is taken again from here by
    // the exact rule, each step checked.
    const int c0 = c, d0 = d;
    unsigned w = c < 0 ? 0u : s_word[c];
    unsigned bad = 0;
#pragma unroll 4
    for (; d > max_len; --d) {
      bad |= (w & PATH_DIST_MASK) ^ (unsigned)d;
      c = (int)(w >> PATH_DIST_BITS);
      w = s_word[c];
    }
#pragma unroll 4
    for (; d >= 1; --d) {
      s_slot[d - 1] = c;
      bad |= (w & PATH_DIST_MASK) ^ (unsigned)d;
      c = (int)(w >> PATH_DIST_BITS);
      w = s_word[c];
    }
    if (bad != 0) {
      c = c0;
      for (d = d0; d >= 1; --d) {
        if (d <= max_len) s_slot[d - 1] = c;
        const int p = walk_pred(dist_in, blocked, L, H, c / H, c % H, d);
        c = p < 0 ? c : p;
      }
    }
    s_written = reachable ? len : 0;
    meta[0] = len;
    meta[1] = reachable ? 1 : 0;
  }
  __syncthreads();
  const int written = s_written;
  const int raw_l = (int)goal[0], raw_h = (int)goal[1];
  for (int j = threadIdx.x; j < max_len; j += blockDim.x) {
    const int c = j < written ? s_slot[j] : -1;
    path[2 * j] = c >= 0 ? c / H : (c == SLOT_RAW_GOAL ? raw_l : -1);
    path[2 * j + 1] = c >= 0 ? c % H : (c == SLOT_RAW_GOAL ? raw_h : -1);
  }
}

// The limits, for the launchers in kernels.py to read and name in their
// refusal: out[0] = PLAN_MAX_NODES, out[1] = PLAN_MAX_PATH.
extern "C" void nbp_plan_limits(int* out) {
  out[0] = PLAN_MAX_NODES;
  out[1] = PLAN_MAX_PATH;
}

// Both take n_b scenes, an optional skip flag a scene (null: none) and
// refuse (cudaErrorInvalidValue) n_b < 1, a lattice past PLAN_MAX_NODES
// nodes or a path buffer past PLAN_MAX_PATH.
extern "C" int nbp_bfs_field(const void* blocked, const void* start,
                             const void* skip, int n_b, int L, int H,
                             void* dist, void* stream) {
  if (n_b < 1 || L <= 0 || H <= 0 || L * H > PLAN_MAX_NODES)
    return (int)cudaErrorInvalidValue;
  const RowLayout g = row_layout(L, H);
  const auto* b = (const unsigned char*)blocked;
  const auto* s = (const long long*)start;
  const auto* k = (const bool*)skip;
  auto* out = (int*)dist;
  const cudaStream_t st = (cudaStream_t)stream;
  if (g.R > BFS_WARP_ROWS) {
    const int rows = (g.R + WARP - 1) / WARP * WARP;
    const int threads = rows < BFS_WIDE_THREADS ? rows : BFS_WIDE_THREADS;
    bfs_wide_kernel<<<n_b, threads, 0, st>>>(b, s, k, g, out);
    return (int)cudaGetLastError();
  }
  const int rpl = g.R <= WARP ? 1 : (g.R <= 2 * WARP ? 2 : 4);
  // A warp a scene, as many a block as the shared memory holds.
  const int bytes = (L * H + 3) / 4 * 4 * (int)sizeof(int);
  int warps = BFS_SHARED_BYTES / bytes;
  warps = warps > BFS_MAX_WARPS ? BFS_MAX_WARPS : warps;
  warps = warps > n_b ? n_b : warps;
#define NBP_BFS_WARP(Word, RPL)                                              \
  bfs_warp_kernel<Word, RPL><<<(n_b + warps - 1) / warps, warps * WARP,      \
                               (size_t)warps * bytes, st>>>(b, s, k, n_b, g, out)
  if (g.W <= 32) {
    if (rpl == 1) NBP_BFS_WARP(unsigned, 1);
    else if (rpl == 2) NBP_BFS_WARP(unsigned, 2);
    else NBP_BFS_WARP(unsigned, 4);
  } else {
    if (rpl == 1) NBP_BFS_WARP(u64, 1);
    else if (rpl == 2) NBP_BFS_WARP(u64, 2);
    else NBP_BFS_WARP(u64, 4);
  }
#undef NBP_BFS_WARP
  return (int)cudaGetLastError();
}

extern "C" int nbp_extract_path(const void* dist, const void* blocked,
                                const void* goal, const void* skip, int n_b,
                                int L, int H, int max_len, void* path,
                                void* meta, void* stream) {
  if (n_b < 1 || L <= 0 || H <= 0 || L * H > PLAN_MAX_NODES || max_len <= 0 ||
      max_len > PLAN_MAX_PATH)
    return (int)cudaErrorInvalidValue;
  extract_path_kernel<<<n_b, PATH_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)dist, (const unsigned char*)blocked, (const long long*)goal,
      (const bool*)skip, L, H, max_len, (int*)path, (int*)meta);
  return (int)cudaGetLastError();
}
