"""What every run shares: the spec and the files found by name, the
cache directories, the clock since the process started and the guard
against the JAX package."""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict, Iterable, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# Top-level modules that may not be loaded in a run's process: the JAX
# package and JAX itself. Names compare whole: ``nextbestpath_tpu_torch``
# is the program and is not ``nextbestpath_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "nextbestpath_tpu")

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries: Iterable[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{what} {name!r} is not in BENCHMARK.json")


def load_module(path: str, name: str):
    """A Python file loaded by path (metric readers carry dots in their
    names, so they are not importable as modules)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the spec, with its configuration, its traffic mix
    and the metrics it reports, each read from the file its name
    gives."""

    def __init__(self, spec: Dict, name: str, root: str = ROOT,
                 bench_dir: str = BENCH_DIR):
        self.spec = spec
        self.bench_dir = bench_dir
        self.workload = by_name(spec["workloads"], name, "workload")
        self.name = name
        cfg = by_name(spec["configs"], self.workload["config"], "config")
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic_name = self.workload["traffic"]
        self.mix = load_json(os.path.join(bench_dir, "mixes",
                                          f"{self.traffic_name}.json"))
        self.chips = int(self.workload["chips"])

    def _reports(self, metric: Dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self._reports(m) and m["moves"] in e2e]

    def reader(self, metric_name: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{metric_name}.py"),
                           "nbp_metric_" + metric_name.replace(".", "_"))


def setup_env(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run in a checkout builds. The program's own
    kernel library goes to ``nextbestpath_tpu_torch/_build/`` beside its
    sources, named by their hash."""
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = os.path.join(cache, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["USE_FLAX"] = "0"


def seconds_since_start() -> float:
    """Seconds since this process started, from the kernel's record of
    its start time (Linux); the set-up time counts interpreter start-up
    and imports."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.process_time()


def forbidden_loaded(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules`` (sys.modules' keys),
    compared whole."""
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(t for t in tops if t in FORBIDDEN)

