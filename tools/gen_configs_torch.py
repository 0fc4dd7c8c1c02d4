#!/usr/bin/env python
"""Write the shipped config tree (the reference's configs/ layout: nbp/,
test/ x difficulty, macarons/, scone/{occupancy,coverage_gain}) with the
PyTorch port's tools: the counterpart of ``tools/gen_configs.py``, which
writes the same files byte for byte.

    python tools/gen_configs_torch.py [--out configs] [--device cuda|cpu]

Idempotent. ``--out`` is the tree's root (default ``configs/`` beside
``tools/``). The tree is plain JSON and no tensor is made; like every port
tool, it runs where ``--device`` says and exits 2 when the card is asked
for and absent.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COMMON = {
    "_camera_management": {
        "image_height": 256,
        "image_width": 456,
        "ambient_light_intensity": 0.85,
        "gathering_factor": 0.05,
        "sensor_range": 70.0,
        "n_interpolation_steps": 4,
        "n_poses_in_trajectory": 100,
    },
    "_scene_management": {
        "n_proxy_points": 20000,
        "proxy_cell_resolution": 0.001,
        "proxy_cell_capacity": 20000,
        "score_threshold": 0.95,
        "carving_tolerance": 10.0,
        "surface_cell_capacity": 2000,
        "n_gt_surface_points": 20000,
        "surface_epsilon_factor": 1.0,
    },
    "_depth_module": {
        "use_perfect_depth": True,
        "use_depth_mask": True,
        "znear": 0.5,
        "zfar": 750,
        "n_alpha": 2,
        "alphas": [-1, -2, 1],
        "n_alpha_for_supervision": 3,
    },
    "_scone_modules": {
        "view_state_n_elev": 7,
        "view_state_n_azim": 14,
        "harmonic_degree": 8,
        "n_harmonics": 64,
        "k_for_knn": 16,
        "seq_len": 2048,
    },
    "_camera_intrinsics": {"fov_degrees": 60.0, "camera_znear": 1.0},
    "_nbp_pipeline": {
        "pc2img_size": [256, 256],
        "prediction_range": [-40.0, 40.0],
        "value_map_size": [64, 64],
        "n_pieces": 4,
        "full_pc_capacity": 2000000,
        "points_per_frame": 6144,
        "max_path_len": 96,
    },
}


def config_tree() -> dict:
    """Every config file of the tree, {path under the root: its dict}, in
    the order they are written."""
    tree = {}
    # 1. NBP training (reference configs/nbp/nbp_default_training_config.json)
    nbp = copy.deepcopy(COMMON)
    nbp["_monitoring"] = {"compute_time": True, "check_gradients": False,
                          "debug_nans": False}
    nbp["_data"] = {
        "data_path": "./data/procgen",
        "train_scenes": ["procgen:simple:2", "procgen:normal:2",
                         "procgen:hard:2", "procgen:insane:2"],
        "val_scenes": ["procgen:simple:1"],
        "test_scenes": ["procgen:simple:1"],
        "data_augmentation": True,
        "symmetry_probability": 0.5,
        "axis_to_mirror": [0],
        "scene_scale_factor": 10.0,
    }
    nbp["_general_training"] = {
        "epochs": 100, "nbp_lr": 0.001, "nbp_batch_size": 56,
        "save_model_every_n_epoch": 3, "random_seed": 8,
    }
    tree["nbp/nbp_default_training_config.json"] = nbp

    # 2-5. Per-difficulty NBP planning test configs
    # (reference configs/test/test_via_nbp_model.json x AiMDoom level)
    for diff in ("simple", "normal", "hard", "insane"):
        cfg = copy.deepcopy(COMMON)
        cfg["_test"] = {
            "dataset_path": "./data/procgen",
            "test_scenes": [f"procgen:{diff}:1"],
            "results_json_name": f"procgen_{diff}.json",
            "test_resolution": 0.05,
            "use_perfect_depth_map": True,
            "random_seed": 8,
            "nbp_weights": "weights/nbp/nbp_best_val.ckpt",
        }
        cfg["_data"] = {"scene_scale_factor": 10.0}
        tree[f"test/test_via_nbp_model_{diff}.json"] = cfg

    # 6. MACARONS scene tester (reference test_in_default_scenes_config.json)
    cfg = copy.deepcopy(COMMON)
    cfg["_test"] = {
        "dataset_path": "./data/procgen",
        "test_scenes": ["procgen:simple:1"],
        "results_json_name": "macarons_nbv_simple.json",
        "test_resolution": 0.05,
        "use_perfect_depth_map": True,
        "random_seed": 8,
        "macarons_weights": "weights/macarons/macarons_online.ckpt",
    }
    cfg["_data"] = {"scene_scale_factor": 10.0}
    tree["test/test_in_default_scenes_config.json"] = cfg

    # 7. Object NBV tester (reference test_on_shapenet_*_config.json)
    tree["test/test_on_objects_config.json"] = {
        "_test": {
            "n_objects": 8,
            "n_views": 10,
            "results_json_name": "object_nbv.json",
            "random_seed": 8,
            "scone_weights": "weights/scone",
        },
        "_scone_modules": copy.deepcopy(COMMON["_scone_modules"]),
    }

    # 8-9. MACARONS online training (reference macarons/*.json)
    for name, pretrained in (
        ("macarons_default_training_config", True),
        ("macarons_training_no_pretraining_config", False),
    ):
        cfg = copy.deepcopy(COMMON)
        cfg["_data"] = {
            "data_path": "./data/procgen",
            "train_scenes": ["procgen:simple:1"],
            "scene_scale_factor": 10.0,
        }
        cfg["_general_training"] = {
            "n_poses_in_trajectory": 100,
            "start_from_pretrained_scone": pretrained,
            "learning_rate": 0.0001,
            "depth_learning_rate": 0.0001,
            "memory_replay_loops": 2,
            "remap_every_n_poses": 20,
            "random_seed": 8,
        }
        tree[f"macarons/{name}.json"] = cfg

    # 10-13. SCONE pretraining (reference scone/{occupancy,coverage_gain}/*)
    for head in ("occupancy", "coverage_gain"):
        for stage in ("initialization", "pretraining"):
            tree[f"scone/{head}/{head}_{stage}_config.json"] = {
                "_scone_modules": copy.deepcopy(COMMON["_scone_modules"]),
                "_general_training": {
                    "steps": 50 if stage == "initialization" else 2000,
                    "n_objects": 8,
                    "learning_rate": 0.0001,
                    "schedule": "warmup_constant",
                    "warmup_steps": 100,
                    "cov_loss_fn": "uncentered_l1",
                    "random_seed": 8,
                },
            }
    return tree


def main(argv=None) -> dict:
    """Writes the tree under ``--out`` and returns it, {path: dict}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "configs"),
                    help="root of the config tree")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.eval import quality as Q

    Q.tool_device("gen_configs_torch", args.device)
    tree = config_tree()
    for rel, cfg in tree.items():
        path = os.path.join(args.out, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        print("wrote", rel)
    return tree


if __name__ == "__main__":
    main()
