"""The readers of the program's spans and counters on whole ``--trace 1``
runs of both cells at CPU sizes (``tiny.py``): each host-side metric is
in the result line and finite, and the walk's draws make 8 provider
calls a scene a batch pose. The idle readers' sweep is checked on a
hand-made slice."""

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest

from nbp_bench.metrics import program_spans
from nbp_bench.tests.tiny import ROOT, tiny_root

HOST_SIDE = {"walk_simple_b4": ("draws_ms.walk", "launch_ms.walk",
                                "draw_calls.walk", "launches.walk",
                                "host_lead_ms.walk"),
             "train_b56": ("forward_ms.train", "backward_ms.train",
                           "optimizer_ms.train", "host_lead_ms.train")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", ["walk_simple_b4", "train_b56"])
def test_traced_run_reports_the_program_spans(root, cell):
    # A process of its own, as the benchmark runs a cell: the readers take
    # no record from after a profiled one, whatever cell made it.
    argv = ["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds",
            "0.5", "--trace", "1"]
    code = ("import sys; from nbp_bench import run; "
            f"sys.exit(run.main({argv!r}, device='cpu', root={root!r}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    metrics = line["metrics"]
    for name in HOST_SIDE[cell]:
        assert name in metrics, sorted(metrics)
        assert math.isfinite(metrics[name]["value"]), (name, metrics[name])
    if cell == "walk_simple_b4":
        with open(f"{root}/nbp_bench/mixes/simple_b4_walk.json") as f:
            n_scenes = len(json.load(f)["scene_seeds"])
        assert metrics["draw_calls.walk"]["value"] == 8 * n_scenes
        # The CPU's ops are plain PyTorch: no kernel of the port launches.
        assert metrics["launches.walk"]["value"] == 0


def test_idle_gaps_go_to_the_innermost_span_over_their_middle(monkeypatch):
    """Spans a [0, 10] > b [2, 6] > c [3, 4], and d [7, 9] on another
    thread; device busy [0, 1], [3.2, 3.3], [5, 8]: the gaps [1, 3.2]
    (middle 2.1: b), [3.3, 5] (middle 4.15: b), [8, 10] (middle 9: d at
    its end)."""
    rec = SimpleNamespace(spans={"a": 0, "b": 0, "c": 0, "d": 0})
    monkeypatch.setattr(program_spans, "_records", lambda: [rec])
    sl = SimpleNamespace(
        host=[(0.0, 10.0, "a"), (2.0, 6.0, "b"), (3.0, 4.0, "c"),
              (7.0, 9.0, "d"), (2.5, 2.6, "aten::add")],
        kernels=[(0.0, 1.0, "k"), (3.2, 3.3, "k"), (5.0, 8.0, "k")])
    by = program_spans.idle_by_span({"slice": sl, "slice_s": 10.0})
    assert by == pytest.approx({"b": 2.2 + 1.7, "d": 2.0})
    assert program_spans.idle_in({"slice": sl, "slice_s": 10.0}, "d") == \
        pytest.approx(20.0)


def test_host_metrics_read_the_cells_records_before_any_profiler(
        monkeypatch):
    """Of a warm-up rollout, two of the cell's size, a profiled one and a
    later one (which CUPTI, still attached, slows), the median reads the
    two."""
    def rec(poses, ms, profiled=False):
        return SimpleNamespace(
            kind="rollout", units={"batch_poses": poses, "scenes": 4},
            profiled=profiled, spans={"draws": [poses, ms * poses / 1e3,
                                                0.0]}, counts={},
            host_s=lambda name: ms * poses / 1e3)
    monkeypatch.setattr(program_spans, "_records", lambda: [
        rec(3, 9.0), rec(101, 4.0), rec(101, 5.0), rec(101, 7.0, True),
        rec(101, 8.0)])
    layer = {"rollouts": [{"poses": 404}]}
    got = program_spans.median(
        layer, lambda r: 1e3 * r.host_s("draws") / r.units["batch_poses"],
        "draws")
    assert got == pytest.approx(4.5)
