"""A later change extends the benchmark by adding files and entries only:
a configuration, a mix and a per-layer metric, found by their names."""

import json
import os
import shutil

from nbp_bench import common


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(common.BENCH_DIR, os.path.join(root, "nbp_bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), root)
    before = {os.path.relpath(os.path.join(d, f), root): open(
        os.path.join(d, f), "rb").read()
        for d, _, fs in os.walk(root) for f in fs}
    bench = os.path.join(root, "nbp_bench")

    with open(os.path.join(bench, "configs", "nbp_eval_bf16.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "nbp_eval_gt40k"
    cfg["params"]["n_gt_surface_points"] = 40000
    with open(os.path.join(bench, "configs", "nbp_eval_gt40k.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "mixes", "simple_b4_walk.json")) as f:
        mix = json.load(f)
    mix["level"] = "hard"
    with open(os.path.join(bench, "mixes", "hard_b4_walk.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "rollouts.walk.py"), "w") as f:
        f.write('LAYER = "rollout"\nUNIT = "count"\nMOVES = "poses_per_s"\n'
                'CELLS = ("walk_hard_b4",)\n\n\ndef read(layer):\n'
                '    return float(len(layer["rollouts"]))\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "nbp_eval_gt40k", "source": "x",
                            "file": "nbp_bench/configs/nbp_eval_gt40k.json",
                            "reduced": [], "why": "more GT points"})
    spec["workloads"].append({"name": "walk_hard_b4",
                              "config": "nbp_eval_gt40k",
                              "traffic": "hard_b4_walk", "chips": 1,
                              "why": "hard"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "walk_simple_b4" in m["workloads"]:
            m["workloads"].append("walk_hard_b4")
    spec["per_layer"].append({"name": "rollouts.walk", "unit": "count",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "rollout", "moves": "poses_per_s",
                              "workloads": ["walk_hard_b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    for rel, data in before.items():
        if rel != "BENCHMARK.json":
            assert open(os.path.join(root, rel), "rb").read() == data, rel
    cell = common.Cell(common.load_spec(root), "walk_hard_b4", root=root,
                       bench_dir=bench)
    assert cell.config["params"]["n_gt_surface_points"] == 40000
    assert cell.mix["level"] == "hard" and cell.mix["kind"] == "rollouts"
    assert "rollouts.walk" in [m["name"] for m in cell.per_layer()]
    assert cell.reader("rollouts.walk").read({"rollouts": [1, 2]}) == 2.0
    assert "poses_per_s" in [m["name"] for m in cell.end_to_end()]
