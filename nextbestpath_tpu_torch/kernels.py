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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Launch counts, one per kernel; only a real launch adds to them.
LAUNCHES: Dict[str, int] = {"ray_hits_pinhole": 0, "ray_hits": 0,
                            "min_sq_dists": 0, "bfs_field": 0,
                            "extract_path": 0}

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "nbp_ray_hits_pinhole": [_P, _I, _I, _P, _I, _P, _F, _F, _P, _P, _P,
                             _P],
    "nbp_ray_hits": [_P, _P, _I, _P, _I, _P, _F, _F, _P, _P, _P, _P],
    "nbp_ray_hits_lanes": [_I, _I],
    "nbp_min_sq_dists": [_P, _I, _P, _I, _P, _P, _P],
    "nbp_min_sq_dists_tiling": [_I, _I, _I, _P],
    "nbp_bfs_field": [_P, _P, _I, _I, _P, _P],
    "nbp_extract_path": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "nbp_plan_limits": [_P],
}
_NO_RESULT = ("nbp_min_sq_dists_tiling", "nbp_plan_limits")


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


def ray_hits_pinhole(dirs: torch.Tensor, ph_soa: torch.Tensor, n_tris,
                     t_min: float, t_max: float):
    """K1 launch over B frames: dirs (B, N, 3) f32, pinhole SoA (B, 10, F)
    f32, one triangle count for all frames -> (t, cnt, idx), each (B, N).
    t_min must be >= 0: the kernel folds each triangle's sign into its data,
    which holds only for hits in front of the origin."""
    if not t_min >= 0.0:
        raise ValueError(f"t_min must be >= 0 for the pinhole kernel, got "
                         f"{t_min}")
    _check(dirs, "dirs", torch.float32, (None, None, 3))
    _check(ph_soa, "ph_soa", torch.float32, (dirs.shape[0], 10, None))
    lib = build()
    dev = dirs.device
    b, n = dirs.shape[0], dirs.shape[1]
    nt = _count_tensor(n_tris, dev)
    t = torch.empty((b, n), dtype=torch.float32, device=dev)
    cnt = torch.empty((b, n), dtype=torch.int32, device=dev)
    idx = torch.empty((b, n), dtype=torch.int32, device=dev)
    err = lib.nbp_ray_hits_pinhole(
        dirs.data_ptr(), b, n, ph_soa.data_ptr(), ph_soa.shape[2],
        nt.data_ptr(), float(t_min), float(t_max), t.data_ptr(),
        cnt.data_ptr(), idx.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_ray_hits_pinhole")
    LAUNCHES["ray_hits_pinhole"] += 1
    return t, cnt, idx


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


def min_sq_dists(g: torch.Tensor, s: torch.Tensor, s_count) -> torch.Tensor:
    """K3 launch: g (G, 3), sentinel-masked samples s (S, 3), valid-prefix
    length s_count -> (G,) min squared distance (1e30 for none)."""
    _check(g, "gt", torch.float32, (None, 3))
    _check(s, "samples", torch.float32, (None, 3))
    lib = build()
    dev = g.device
    sc = _count_tensor(s_count, dev)
    out = torch.empty(g.shape[0], dtype=torch.float32, device=dev)
    err = lib.nbp_min_sq_dists(g.data_ptr(), g.shape[0], s.data_ptr(),
                               s.shape[0], sc.data_ptr(), out.data_ptr(),
                               _stream(dev))
    _raise_on(err, "nbp_min_sq_dists")
    LAUNCHES["min_sq_dists"] += 1
    return out


def min_sq_dists_tiling(n_g: int, n_s: int, device=None) -> Dict[str, int]:
    """K3's tiling for n_g GT points against a capacity of n_s samples on
    the card: GT points a block, samples a split, and splits."""
    lib = build()
    out = (ctypes.c_int * 3)()
    lib.nbp_min_sq_dists_tiling(int(n_g), int(n_s), _sm_count(device), out)
    return {"points_per_block": out[0], "chunk": out[1], "splits": out[2]}


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


def bfs_field(blocked: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """nbp_bfs_field launch: blocked (4, L, H) bool, start (2,) int64 ->
    (L, H) int32 unit-cost distances (INF = 2^20 unreachable). Raises
    ValueError for a lattice past the kernel's limit (``plan_limits``)."""
    _check(blocked, "blocked", torch.bool, (4, None, None))
    _check(start, "start", torch.int64, (2,))
    L, H = blocked.shape[1], blocked.shape[2]
    _check_lattice(L, H)
    lib = build()
    dev = blocked.device
    dist = torch.empty((L, H), dtype=torch.int32, device=dev)
    err = lib.nbp_bfs_field(blocked.data_ptr(), start.data_ptr(), L, H,
                            dist.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_bfs_field")
    LAUNCHES["bfs_field"] += 1
    return dist


def extract_path(dist: torch.Tensor, blocked: torch.Tensor,
                 goal: torch.Tensor, max_len: int):
    """nbp_extract_path launch: dist (L, H) int32, blocked (4, L, H) bool,
    goal (2,) int64 -> (path (max_len, 2) int32, meta (2,) int32 holding
    the path length and whether the goal is reachable). Raises ValueError
    past the kernel's limits (``plan_limits``)."""
    _check(dist, "dist", torch.int32, (None, None))
    L, H = dist.shape
    _check(blocked, "blocked", torch.bool, (4, L, H))
    _check(goal, "goal", torch.int64, (2,))
    _check_lattice(L, H, max_len)
    lib = build()
    dev = dist.device
    path = torch.empty((max_len, 2), dtype=torch.int32, device=dev)
    meta = torch.empty(2, dtype=torch.int32, device=dev)
    err = lib.nbp_extract_path(dist.data_ptr(), blocked.data_ptr(),
                               goal.data_ptr(), L, H, int(max_len),
                               path.data_ptr(), meta.data_ptr(), _stream(dev))
    _raise_on(err, "nbp_extract_path")
    LAUNCHES["extract_path"] += 1
    return path, meta


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
