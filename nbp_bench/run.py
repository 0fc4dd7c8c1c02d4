#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it starts on.

    python3 nbp_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window. ``--control 1``
also prints what the comparison reads when the control (the plain
reference one precision lower) and, for training, a planted fault stand
in for the program, and ``correct`` as it reads for each of them against
the same limits (``control_correct``); the benchmark's own runs never
pass it.

Every number compared goes to stderr beside its limit, as the last
lines; the last line of stdout is the result, one JSON object. A run
with no CUDA card, or fewer cards than the cell asks for, exits 2 and
prints no result; so does a run in whose process the JAX package or JAX
is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from nbp_bench import common  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(cell: common.Cell, out, trace: bool, device_kind: str,
           count: int) -> dict:
    """The result line's object; the numbers compared come last."""
    if trace:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(out.layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": out.memory_peak_bytes}
    if trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.traced_s
    from nbp_bench.checks import correct, stand_in_verdicts
    line = {"correct": correct(out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    if out.control is not None:
        line["control"] = out.control
        line["control_correct"] = stand_in_verdicts(out.checks, out.control)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None, device: str = "cuda", root: str = ROOT) -> int:
    """One run; ``device="cpu"`` (tests only) skips the look for a card
    and runs the program's plain versions."""
    args = _args(argv)
    common.setup_env(root)
    import torch

    cell = common.Cell(common.load_spec(root), args.workload, root=root,
                       bench_dir=os.path.join(root, os.path.basename(HERE)))
    if device == "cuda":
        if not torch.cuda.is_available():
            print("run.py: no CUDA card (torch.cuda.is_available() is "
                  "False); nothing measured", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"run.py: the cell needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    driver = importlib.import_module(f"nbp_bench.drivers.{cell.mix['kind']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     bool(args.control), device=device)
    bad = common.forbidden_loaded(sys.modules)
    if bad and device == "cuda":
        print(f"run.py: {', '.join(bad)} loaded in the run's process; no "
              f"result", file=sys.stderr)
        return 2
    line = result(cell, out, bool(args.trace), kind, cell.chips)
    if out.control is not None:
        for k, v in out.control.items():
            print(f"control {k} {v!r}", file=sys.stderr)
        for who, ok in line["control_correct"].items():
            print(f"control {who} correct {ok}", file=sys.stderr)
    for k, (v, lim) in out.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
