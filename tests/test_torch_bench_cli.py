"""``bench_torch.py``'s command line on the CPU: its one JSON line at
``--quick`` and the flags beside ``bench.py``'s (``--dtype``,
``--stratified``, ``--batched-capture``). Each test runs the bench's
``main`` in-process over the port's scan rollout at the quick config.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_torch_prints_its_line():
    sys.path.insert(0, REPO)
    import bench_torch

    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_torch.main(["--device", "cpu", "--quick", "--poses", "2",
                               "--warmup-poses", "1"])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "env_steps_per_sec" and line["unit"] == "poses/s"
    assert line["runs"] == 5 and line["device"] == "cpu"
    assert line["min"] <= line["value"] <= line["max"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 0.5)
    assert 0.0 <= line["coverage_final"] <= 1.0 and line["auc"] > 0
    assert (line["dtype"], line["stratified"], line["batched_capture"]) == (
        "float32", False, False)
    if not torch.cuda.is_available():
        assert bench_torch.main(["--quick"]) == 2


@pytest.mark.parametrize("flags", [["--dtype", "bfloat16"], ["--stratified"],
                                   ["--batched-capture"]])
def test_bench_torch_options(flags):
    """The flags beside bench.py's reach the rollout and the line: at
    --quick (64x114 frames, 1024 points a frame) a stratum is 8 pixels and
    the stratified draw applies."""
    sys.path.insert(0, REPO)
    import bench_torch

    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_torch.main(["--device", "cpu", "--quick", "--poses", "2",
                               "--warmup-poses", "1"] + flags)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[0])
    assert line["dtype"] == ("bfloat16" if "bfloat16" in flags else "float32")
    assert line["stratified"] == ("--stratified" in flags)
    assert line["batched_capture"] == ("--batched-capture" in flags)
    assert 0.0 <= line["coverage_final"] <= 1.0 and line["auc"] > 0
