"""Build, load and launch the port's CUDA kernels.

All ``csrc/*.cu`` are compiled by one ``nvcc`` call into one shared library
with a plain C interface, which ``ctypes`` loads; nothing includes PyTorch's
headers, so the build takes seconds. The library's file name carries a hash
of the sources and lands in ``_build/`` beside this file, which git ignores.
The build runs at the first launch (or at ``build()``), never at import.

Each launcher takes CUDA tensors, checks them, launches on PyTorch's current
stream, adds one to its count in ``LAUNCHES`` and raises if the launch was
refused. It never falls back to a plain version: those live beside the
dispatching wrappers in ``ops/`` and are taken only for CPU tensors.

K1, K3 and the planner kernels also launch with a leading scene axis (the
``*_scenes`` launchers, counted apart): the batched rollouts' one launch for
B scenes, each with its own triangle count, sample count, lattice, start or
goal, where the JAX package vmaps the single-scene kernel.

The Gumbel-max token draw (``csrc/gumbel.cu``) has two launchers:
``gumbel_noise`` (G1) serves Gumbel noise from a CUDA generator, the bits of
``torch.rand``'s stream and the eager chain's transform, and
``gumbel_argmax`` (G2) takes every candidate's tokens from its served noise
and log-probabilities.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Launch counts, one per kernel; only a real launch adds to them.
LAUNCHES: Dict[str, int] = {"ray_hits_pinhole": 0, "ray_hits": 0,
                            "min_sq_dists": 0, "bfs_field": 0,
                            "extract_path": 0, "ray_hits_pinhole_scenes": 0,
                            "min_sq_dists_scenes": 0,
                            "bfs_field_scenes": 0,
                            "extract_path_scenes": 0, "gumbel_noise": 0,
                            "gumbel_argmax": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nbp_ray_hits_pinhole": [_P, _I, _I, _I, _P, _I, _P, _I, _F, _F, _P,
                             _P, _P, _P],
    "nbp_ray_hits": [_P, _P, _I, _P, _I, _P, _F, _F, _P, _P, _P, _P],
    "nbp_ray_hits_lanes": [_I, _I],
    "nbp_min_sq_dists": [_P, _I, _I, _P, _I, _P, _P, _P, _P],
    "nbp_min_sq_dists_plan": [_P, _I, _I, _I, _I, _P, _P],
    "nbp_min_sq_dists_blocks": [],
    "nbp_bfs_field": [_P, _P, _P, _I, _I, _I, _P, _P],
    "nbp_extract_path": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "nbp_plan_limits": [_P],
    "nbp_gumbel_noise": [_P, _P, _P, _P, _I, ctypes.c_uint64, _P],
    "nbp_gumbel_argmax": [_P, _I, _P, _I, _I, _I, _P, _P],
}
_NO_RESULT = ("nbp_plan_limits",)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_replay(launches: Dict[str, int]) -> None:
    """Add the launches of one CUDA graph replay: the launches its capture
    recorded (a capture itself launches nothing)."""
    for k, n in launches.items():
        LAUNCHES[k] += n


def _sources():
    names = sorted(n for n in os.listdir(CSRC)
                   if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC, n) for n in names]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libnbp_kernels_{h.hexdigest()[:16]}.so")


def build() -> ctypes.CDLL:
    """Compile (if this source hash was not built yet) and load the library.

    Records in BUILD_INFO the path, whether it compiled, the seconds it took
    and nvcc's output (``-Xptxas -v`` register and shared-memory report)."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    t0 = time.perf_counter()
    log = ""
    compiled = False
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = find_nvcc()
        cu = [p for p in _sources() if p.endswith(".cu")]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
        compiled = True
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None if name in _NO_RESULT else ctypes.c_int
    BUILD_INFO.update(path=path, compiled=compiled,
                      seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None:
        for want, got in zip(shape, x.shape):
            if want is not None and want != got:
                raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                                 f"expected {shape}")
        if len(shape) != x.dim():
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")


def _count_tensor(n, device) -> torch.Tensor:
    """A (1,) int32 count on the device; a tensor is used as it is."""
    if isinstance(n, torch.Tensor):
        n = n.reshape(1).to(device=device, dtype=torch.int32)
        return n.contiguous()
    return torch.tensor([int(n)], dtype=torch.int32, device=device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def _sm_count(device=None) -> int:
    return torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else device).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _pinhole_launch(dirs, ph_soa, nt, count_stride, t_min, t_max, width):
    """K1 over B frames with one count (count_stride 0) or one a frame
    (count_stride 1); ``width`` the frames' image width (8 x 16 pixel
    tiles)."""
    if not t_min >= 0.0:
        raise ValueError(f"t_min must be >= 0 for the pinhole kernel, got "
                         f"{t_min}")
    _check(dirs, "dirs", torch.float32, (None, None, 3))
    _check(ph_soa, "ph_soa", torch.float32, (dirs.shape[0], 10, None))
    _check(nt, "n_tris", torch.int32,
           (dirs.shape[0] if count_stride else 1,))
    b, n = dirs.shape[0], dirs.shape[1]
    width = int(width)
    if width < 1 or n % width:
        raise ValueError(f"width {width} does not divide the {n} rays of a "
                         f"frame")
    lib = build()
    dev = dirs.device
    t = torch.empty((b, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, n), dtype=torch.int32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    err = lib.nbp_ray_hits_pinhole(
        dirs.data_ptr(), b, n, width, ph_soa.data_ptr(), ph_soa.shape[2],
        nt.data_ptr(), count_stride, float(t_min), float(t_max),
        t.data_ptr(), cnt.data_ptr(), idx.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_ray_hits_pinhole")
    return t, cnt, idx


def ray_hits_pinhole(dirs: torch.Tensor, ph_soa: torch.Tensor, n_tris,
                     t_min: float, t_max: float, width: int):
    """K1 launch over B frames: dirs (B, N, 3) f32, pinhole SoA (B, 10, F)
    f32, one triangle count for all frames -> (t, cnt, idx), each (B, N).
    t_min must be >= 0: the kernel folds each triangle's sign into its data,
    which holds only for hits in front of the origin. ``width``: each
    frame's rays are a row-major image that wide (N a multiple of it), cast
    in 8 x 16 pixel tiles, each culling the triangles its rays cannot hit."""
    out = _pinhole_launch(dirs, ph_soa, _count_tensor(n_tris, dirs.device),
                          0, t_min, t_max, width)
    LAUNCHES["ray_hits_pinhole"] += 1
    return out


def ray_hits_pinhole_scenes(dirs: torch.Tensor, ph_soa: torch.Tensor,
                            n_tris: torch.Tensor, t_min: float, t_max: float,
                            width: int):
    """K1 launch with a triangle count a frame: dirs (B, N, 3), pinhole SoA
    (B, 10, F) and n_tris (B,) int32 on the card (frames of several scenes
    padded to one F; frame b stops at its own count) -> (t, cnt, idx), each
    (B, N). t_min >= 0 and ``width`` as for ``ray_hits_pinhole``."""
    out = _pinhole_launch(dirs, ph_soa, n_tris, 1, t_min, t_max, width)
    LAUNCHES["ray_hits_pinhole_scenes"] += 1
    return out


def ray_hits(origins: torch.Tensor, dirs: torch.Tensor, soa: torch.Tensor,
             n_tris, t_min: float, t_max: float):
    """K2 launch: origins/dirs (N, 3) f32, SoA (9, F) f32 -> (t, cnt, idx).
    The kernel gives each ray ``ray_hits_lanes(N)`` lanes, chosen on the host
    from N and the SM count."""
    _check(origins, "origins", torch.float32, (None, 3))
    _check(dirs, "dirs", torch.float32, (origins.shape[0], 3))
    _check(soa, "tri_soa", torch.float32, (9, None))
    lib = build()
    dev = dirs.device
    n = dirs.shape[0]
    nt = _count_tensor(n_tris, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    cnt = torch.empty(n, dtype=torch.int32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    err = lib.nbp_ray_hits(
        origins.data_ptr(), dirs.data_ptr(), n, soa.data_ptr(), soa.shape[1],
        nt.data_ptr(), float(t_min), float(t_max), t.data_ptr(),
        cnt.data_ptr(), idx.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_ray_hits")
    LAUNCHES["ray_hits"] += 1
    return t, cnt, idx


def ray_hits_lanes(n_rays: int, device=None) -> int:
    """The lanes a ray (a power of two, 1 to 32) that K2 takes for n_rays
    rays on the card."""
    lib = build()
    return int(lib.nbp_ray_hits_lanes(int(n_rays), _sm_count(device)))


# K3's work split, as csrc/coverage.cu holds it: GT points an item (P x
# THREADS), samples a staged tile (the least chunk) and the items wanted for
# each resident block.
K3_POINTS_PER_ITEM = 1024
K3_TILE = 64
K3_ITEMS_PER_BLOCK = 8


def min_sq_dists_plan(counts, n_g: int, n_s: int, n_blocks: int
                      ) -> Dict[str, object]:
    """K3's plan for valid counts ``counts`` (one a scene) of a capacity of
    n_s samples, n_g GT points a scene and n_blocks resident blocks: the
    host model of the plan the fill kernel makes. A work item is (scene, GT block, sample
    range) over the scene's valid prefix; ``chunk`` is the samples an item,
    ``total * n_gb / (K3_ITEMS_PER_BLOCK * n_blocks)`` rounded up to whole
    tiles and held to [one tile, the tiles of n_s]; ``prefix[b]`` the items
    of the scenes before scene b (``prefix[B]`` all of them). Item i of
    scene b (``i = item - prefix[b]``) is GT block ``i % n_gb``, samples
    from ``(i // n_gb) * chunk`` to the next chunk or the count."""
    counts = [max(0, min(int(c), int(n_s))) for c in counts]
    n_gb = -(-int(n_g) // K3_POINTS_PER_ITEM)
    target = K3_ITEMS_PER_BLOCK * int(n_blocks)
    want = -(-sum(counts) * n_gb // target)
    tiles = min(max(1, -(-want // K3_TILE)), max(1, -(-int(n_s) // K3_TILE)))
    chunk = tiles * K3_TILE
    prefix = [0]
    for c in counts:
        prefix.append(prefix[-1] + n_gb * -(-c // chunk))
    return {"points_per_item": K3_POINTS_PER_ITEM, "gt_blocks": n_gb,
            "chunk": chunk, "prefix": prefix, "items": prefix[-1],
            "blocks": int(n_blocks)}


def min_sq_dists_blocks() -> int:
    """The blocks of one K3 launch on the current card: the blocks an SM
    holds at once (occupancy API) times the SM count."""
    return int(build().nbp_min_sq_dists_blocks())


def min_sq_dists_device_plan(counts: torch.Tensor, n_g: int, n_s: int
                             ) -> torch.Tensor:
    """K3's plan alone on the card (the fill kernel with no output), for
    counts (B,) int32 on the card: (B + 3,) int32, [0] the item counter at
    0, [1] the chunk and [2:] the prefix of ``min_sq_dists_plan``."""
    _check(counts, "s_counts", torch.int32, (None,))
    lib = build()
    plan = torch.full((counts.shape[0] + 3,), -1, dtype=torch.int32,
                      device=counts.device)
    err = lib.nbp_min_sq_dists_plan(counts.data_ptr(), counts.shape[0],
                                    int(n_g), int(n_s), min_sq_dists_blocks(),
                                    plan.data_ptr(), _stream(counts.device))
    _raise_on(err, "nbp_min_sq_dists_plan")
    return plan


def _min_sq_launch(g: torch.Tensor, s: torch.Tensor, counts: torch.Tensor):
    """g (B, G, 3), s (B, S, 3), counts (B,) int32 -> (B, G). The plan's
    scratch is allocated here, one a launch (a graph keeps its own)."""
    lib = build()
    dev = g.device
    n_b, n_g, n_s = g.shape[0], g.shape[1], s.shape[1]
    out = torch.empty((n_b, n_g), dtype=torch.float32, device=dev)
    plan = torch.empty(n_b + 3, dtype=torch.int32, device=dev)
    err = lib.nbp_min_sq_dists(g.data_ptr(), n_b, n_g, s.data_ptr(), n_s,
                               counts.data_ptr(), plan.data_ptr(),
                               out.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_min_sq_dists")
    return out


def min_sq_dists(g: torch.Tensor, s: torch.Tensor, s_count) -> torch.Tensor:
    """K3 launch: g (G, 3), sentinel-masked samples s (S, 3), valid-prefix
    length s_count -> (G,) min squared distance (1e30 for none)."""
    _check(g, "gt", torch.float32, (None, 3))
    _check(s, "samples", torch.float32, (None, 3))
    out = _min_sq_launch(g[None], s[None], _count_tensor(s_count, g.device))
    LAUNCHES["min_sq_dists"] += 1
    return out[0]


def min_sq_dists_scenes(g: torch.Tensor, s: torch.Tensor,
                        s_counts: torch.Tensor) -> torch.Tensor:
    """K3 launch over B scenes: g (B, G, 3), sentinel-masked samples s
    (B, S, 3) and valid-prefix lengths s_counts (B,) int32 on the card ->
    (B, G), scene b's row bit-equal to ``min_sq_dists`` of its own."""
    _check(g, "gt", torch.float32, (None, None, 3))
    _check(s, "samples", torch.float32, (g.shape[0], None, 3))
    _check(s_counts, "s_counts", torch.int32, (g.shape[0],))
    if not 1 <= g.shape[0] <= 65535:
        raise ValueError(f"K3 takes 1 to 65535 scenes, got {g.shape[0]}")
    out = _min_sq_launch(g, s, s_counts)
    LAUNCHES["min_sq_dists_scenes"] += 1
    return out


def plan_limits() -> Dict[str, int]:
    """The planner kernels' limits, as csrc/plan.cu holds them: lattice
    nodes (the shared-memory distance field) and path slots."""
    out = (ctypes.c_int * 2)()
    build().nbp_plan_limits(out)
    return {"nodes": out[0], "path": out[1]}


def _check_lattice(L: int, H: int, max_len: Optional[int] = None) -> None:
    """Refuses a lattice or a path buffer past the kernels' limits."""
    lim = plan_limits()
    if L * H > lim["nodes"]:
        raise ValueError(f"a {L}x{H} lattice has {L * H} nodes; the planner "
                         f"kernels hold at most {lim['nodes']} in shared "
                         f"memory")
    if max_len is not None and not 0 < max_len <= lim["path"]:
        raise ValueError(f"max_len must be in [1, {lim['path']}], got "
                         f"{max_len}")


def _skip_ptr(skip: Optional[torch.Tensor], n_b: int) -> Optional[int]:
    """The device pointer of the planner kernels' skip flags (n_b bools,
    any shape), or None (a null pointer: no scene is skipped)."""
    if skip is None:
        return None
    _check(skip, "skip", torch.bool)
    if skip.numel() != n_b:
        raise ValueError(f"skip has {skip.numel()} flags for {n_b} scenes")
    return skip.data_ptr()


def _bfs_launch(blocked: torch.Tensor, start: torch.Tensor,
                skip: Optional[torch.Tensor]) -> torch.Tensor:
    """blocked (B, 4, L, H) bool, start (B, 2) int64, skip B bools or None
    -> (B, L, H) int32."""
    n_b, L, H = blocked.shape[0], blocked.shape[2], blocked.shape[3]
    _check_lattice(L, H)
    skip_p = _skip_ptr(skip, n_b)
    lib = build()
    dev = blocked.device
    dist = torch.empty((n_b, L, H), dtype=torch.int32, device=dev)
    err = lib.nbp_bfs_field(blocked.data_ptr(), start.data_ptr(), skip_p, n_b,
                            L, H, dist.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_bfs_field")
    return dist


def bfs_field(blocked: torch.Tensor, start: torch.Tensor,
              skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nbp_bfs_field launch: blocked (4, L, H) bool, start (2,) int64 ->
    (L, H) int32 unit-cost distances (INF = 2^20 unreachable). ``skip``, a
    bool on the card (one element), set: the field is all INF and no BFS
    runs. Raises ValueError for a lattice past the kernel's limit
    (``plan_limits``)."""
    _check(blocked, "blocked", torch.bool, (4, None, None))
    _check(start, "start", torch.int64, (2,))
    dist = _bfs_launch(blocked[None], start[None], skip)
    LAUNCHES["bfs_field"] += 1
    return dist[0]


def bfs_field_scenes(blocked: torch.Tensor, start: torch.Tensor,
                     skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nbp_bfs_field over B lattices, one warp a scene: blocked
    (B, 4, L, H) bool, start (B, 2) int64, skip (B,) bool or None ->
    (B, L, H) int32. The limits of ``plan_limits`` hold for each scene."""
    _check(blocked, "blocked", torch.bool, (None, 4, None, None))
    _check(start, "start", torch.int64, (blocked.shape[0], 2))
    dist = _bfs_launch(blocked, start, skip)
    LAUNCHES["bfs_field_scenes"] += 1
    return dist


def _path_launch(dist, blocked, goal, max_len: int,
                 skip: Optional[torch.Tensor]):
    """dist (B, L, H), blocked (B, 4, L, H), goal (B, 2), skip B bools or
    None -> path (B, max_len, 2) int32, meta (B, 2) int32."""
    n_b, L, H = dist.shape
    _check_lattice(L, H, max_len)
    skip_p = _skip_ptr(skip, n_b)
    lib = build()
    dev = dist.device
    path = torch.empty((n_b, max_len, 2), dtype=torch.int32, device=dev)
    meta = torch.empty((n_b, 2), dtype=torch.int32, device=dev)
    err = lib.nbp_extract_path(dist.data_ptr(), blocked.data_ptr(),
                               goal.data_ptr(), skip_p, n_b, L, H,
                               int(max_len), path.data_ptr(), meta.data_ptr(),
                               _stream(dev))
    _raise_on(err, "nbp_extract_path")
    return path, meta


def extract_path(dist: torch.Tensor, blocked: torch.Tensor,
                 goal: torch.Tensor, max_len: int,
                 skip: Optional[torch.Tensor] = None):
    """nbp_extract_path launch: dist (L, H) int32, blocked (4, L, H) bool,
    goal (2,) int64 -> (path (max_len, 2) int32, meta (2,) int32 holding
    the path length and whether the goal is reachable). ``skip``, a bool on
    the card (one element), set: path all -1, meta (0, 0), and no walk.
    Raises ValueError past the kernel's limits (``plan_limits``)."""
    _check(dist, "dist", torch.int32, (None, None))
    L, H = dist.shape
    _check(blocked, "blocked", torch.bool, (4, L, H))
    _check(goal, "goal", torch.int64, (2,))
    path, meta = _path_launch(dist[None], blocked[None], goal[None], max_len,
                              skip)
    LAUNCHES["extract_path"] += 1
    return path[0], meta[0]


def extract_path_scenes(dist: torch.Tensor, blocked: torch.Tensor,
                        goal: torch.Tensor, max_len: int,
                        skip: Optional[torch.Tensor] = None):
    """nbp_extract_path over B lattices, one block a scene: dist (B, L, H)
    int32, blocked (B, 4, L, H) bool, goal (B, 2) int64, skip (B,) bool or
    None -> (path (B, max_len, 2) int32, meta (B, 2) int32)."""
    _check(dist, "dist", torch.int32, (None, None, None))
    n_b, L, H = dist.shape
    _check(blocked, "blocked", torch.bool, (n_b, 4, L, H))
    _check(goal, "goal", torch.int64, (n_b, 2))
    out = _path_launch(dist, blocked, goal, max_len, skip)
    LAUNCHES["extract_path_scenes"] += 1
    return out


# torch.rand's launch on a card (ATen/native/cuda/DistributionTemplates.h,
# calc_execution_policy): 256-thread blocks, curand_uniform4's four floats a
# trip of the grid-stride loop and four Philox counters a trip.
RAND_THREADS = 256
RAND_UNROLL = 4
# The most f32 elements torch.rand fills in one launch: past 2^29 the byte
# offsets leave 32 bits and it splits the tensor, each part advancing the
# generator again.
GUMBEL_MAX_ELEMENTS = 2 ** 29
# As csrc/gumbel.cu holds them: shapes of one G1 launch, candidates of one G2
# launch, and the logits a G2 block stages in shared memory (224 KB).
GUMBEL_SHAPES_A_LAUNCH = 64
ARGMAX_CANDS_A_LAUNCH = 64
ARGMAX_MAX_P = 57344


def rand_policy(n: int, sm_count: int, threads_per_sm: int
                ) -> Tuple[int, int]:
    """torch.rand's launch for n > 0 f32 elements on a card of sm_count
    SMs and threads_per_sm threads an SM: (the grid's blocks, the Philox
    counters the call advances its generator by)."""
    blocks = min(sm_count * (threads_per_sm // RAND_THREADS),
                 -(-n // RAND_THREADS))
    trips = (n - 1) // (RAND_THREADS * blocks * RAND_UNROLL) + 1
    return blocks, trips * RAND_UNROLL


def gumbel_noise(gen: torch.Generator, shapes: Sequence[Sequence[int]]
                 ) -> List[torch.Tensor]:
    """G1 launch: standard Gumbel noise of each shape, f32 on the
    generator's card, bit-equal to ``-log(-log(torch.rand(shape,
    generator=gen).clamp(min=tiny)))`` for the shapes in turn; the
    generator is left where those ``torch.rand`` calls leave it. Up to
    ``GUMBEL_SHAPES_A_LAUNCH`` shapes a launch. Refuses a generator off the
    card, a shape of more than ``GUMBEL_MAX_ELEMENTS`` elements, and a call
    under stream capture (the generator's offset moves on the host)."""
    dev = torch.device(getattr(gen, "device", "cpu"))
    if dev.type != "cuda":
        raise ValueError(f"gumbel_noise takes a CUDA generator, got one on "
                         f"{dev}")
    shapes = [tuple(int(d) for d in s) for s in shapes]
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        if min(s, default=0) < 0 or n > GUMBEL_MAX_ELEMENTS:
            raise ValueError(f"gumbel_noise takes shapes of 0 to "
                             f"{GUMBEL_MAX_ELEMENTS} elements, got {s}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("gumbel_noise cannot run under stream capture: "
                           "it moves the generator's offset on the host")
    lib = build()
    props = torch.cuda.get_device_properties(dev)
    outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    seed, offset = gen.initial_seed(), gen.get_offset()
    todo = []
    for out in outs:
        if out.numel():
            blocks, advance = rand_policy(
                out.numel(), props.multi_processor_count,
                props.max_threads_per_multi_processor)
            todo.append((out, blocks, offset))
            offset += advance
    for i in range(0, len(todo), GUMBEL_SHAPES_A_LAUNCH):
        part = todo[i:i + GUMBEL_SHAPES_A_LAUNCH]
        k = len(part)
        err = lib.nbp_gumbel_noise(
            (ctypes.c_void_p * k)(*[o.data_ptr() for o, _, _ in part]),
            (ctypes.c_longlong * k)(*[o.numel() for o, _, _ in part]),
            (ctypes.c_uint64 * k)(*[off for _, _, off in part]),
            (ctypes.c_int * k)(*[b for _, b, _ in part]), k, seed,
            _stream(dev))
        _raise_on(err, "nbp_gumbel_noise")
        LAUNCHES["gumbel_noise"] += 1
    gen.set_offset(offset)
    return outs


def gumbel_argmax(noise: Sequence[torch.Tensor], logits: torch.Tensor
                  ) -> torch.Tensor:
    """G2 launch: noise, C tensors (n, P) f32, and logits (C, P) f32, each
    contiguous on one card -> (C, n) int64, row c ``torch.argmax(noise[c]
    + logits[c], -1)`` (each score one f32 add, ties to the smaller index).
    The noise is read where it lies; up to ``ARGMAX_CANDS_A_LAUNCH``
    candidates a launch, P at most ``ARGMAX_MAX_P``. The layout is checked
    before the device."""
    named = [(logits, "logits")] + [(z, f"noise[{c}]")
                                    for c, z in enumerate(noise)]
    for x, name in named:
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logits.dim() != 2 or logits.shape[0] != len(noise):
        raise ValueError(f"logits has shape {tuple(logits.shape)}, expected "
                         f"({len(noise)}, P)")
    n_c, p = logits.shape
    n = noise[0].shape[0] if n_c else 0
    for z, name in named[1:]:
        if tuple(z.shape) != (n, p):
            raise ValueError(f"{name} has shape {tuple(z.shape)}, expected "
                             f"({n}, {p})")
    if not 1 <= p <= ARGMAX_MAX_P or n >= 2 ** 31:
        raise ValueError(f"gumbel_argmax takes 1 to {ARGMAX_MAX_P} points "
                         f"and fewer than 2^31 rows, got ({n}, {p})")
    dev = logits.device
    for x, name in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got "
                             f"{x.device}")
    out = torch.empty((n_c, n), dtype=torch.int64, device=dev)
    if n_c == 0 or n == 0:
        return out
    lib = build()
    vec = int(p % 4 == 0 and all(z.data_ptr() % 16 == 0 for z in noise))
    for c0 in range(0, n_c, ARGMAX_CANDS_A_LAUNCH):
        part = noise[c0:c0 + ARGMAX_CANDS_A_LAUNCH]
        k = len(part)
        err = lib.nbp_gumbel_argmax(
            (ctypes.c_void_p * k)(*[z.data_ptr() for z in part]), k,
            logits[c0].data_ptr(), n, p, vec, out[c0].data_ptr(),
            _stream(dev))
        _raise_on(err, "nbp_gumbel_argmax")
        LAUNCHES["gumbel_argmax"] += 1
    return out


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn`` (which launches on the current
    stream), from CUDA events around ``reps`` calls. A device-side sleep
    that outlasts the host's enqueueing of the calls goes first, so the
    launches run back to back and a call whose host cost exceeds its device
    time is still timed on the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.0, 2.0 * reps * host_s + 1e-3) * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
