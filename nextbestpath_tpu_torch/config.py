"""Config system: JSON configs with `_`-prefixed section flattening.

Mirrors the reference's two-level config scheme:
- a global JSON training/test config whose top-level keys starting with `_` are
  section headers flattened into flat attributes
  (reference: macarons/utility/utils.py:44-83, load_params macarons_utils.py:231),
- a per-scene ``settings.json`` pinning scene bbox/grid and the camera pose lattice
  (reference: macarons/utility/macarons_utils.py:2152-2190).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np


def flatten_dict(d: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten one level of `_section` headers into a flat dict.

    Reference: macarons/utility/utils.py:44-49.
    """
    out: Dict[str, Any] = {}
    for key, value in d.items():
        if key.startswith("_") and isinstance(value, dict):
            for sub_key, sub_value in value.items():
                out[sub_key] = sub_value
        else:
            out[key] = value
    return out


class Params:
    """Attribute-style access over a (flattened) config dict.

    Reference: macarons/utility/utils.py:51-83.
    """

    _RESERVED = frozenset({"get", "update", "as_dict"})

    def __init__(self, d: Dict[str, Any], flatten: bool = True):
        if flatten:
            d = flatten_dict(d)
        # Config keys land in __dict__, so a key named like a method would
        # shadow it and break every consumer ('int' is not callable from
        # params.get(...)) — reject such configs loudly.
        bad = self._RESERVED & set(d)
        if bad:
            raise ValueError(
                f"config keys {sorted(bad)} collide with Params methods")
        self.__dict__.update(d)

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def update(self, **kwargs: Any) -> "Params":
        self.__dict__.update(kwargs)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        keys = ", ".join(sorted(self.__dict__))
        return f"Params({keys})"


def load_params(json_path: str, flatten: bool = True) -> Params:
    with open(json_path, "r") as f:
        d = json.load(f)
    return Params(d, flatten=flatten)


# ---------------------------------------------------------------------------
# Defaults mirroring configs/nbp/nbp_default_training_config.json in the
# reference repo. Only the knobs consumed by the TPU build are kept; unused
# torch-specific knobs (AMP, CUDA devices, ...) are dropped.
# ---------------------------------------------------------------------------

DEFAULT_PARAMS: Dict[str, Any] = {
    # data
    "scene_scale_factor": 10.0,
    # camera management
    "image_height": 256,
    "image_width": 456,
    "ambient_light_intensity": 0.85,
    "gathering_factor": 0.05,
    "sensor_range": 70.0,
    "n_interpolation_steps": 4,
    "n_poses_in_trajectory": 100,
    # scene management
    "n_proxy_points": 20000,
    "proxy_cell_resolution": 0.001,
    "proxy_cell_capacity": 20000,
    "score_threshold": 0.95,
    "carving_tolerance": 10.0,
    "surface_cell_capacity": 2000,
    "n_gt_surface_points": 20000,
    "surface_epsilon_factor": 1.0,
    # depth module
    "use_perfect_depth": True,
    "use_depth_mask": True,
    "znear": 0.5,
    "zfar": 750.0,
    "n_alpha": 2,
    "alphas": [-1, -2, 1],
    "n_alpha_for_supervision": 3,
    # scone modules
    "view_state_n_elev": 7,
    "view_state_n_azim": 14,
    "harmonic_degree": 8,
    "n_harmonics": 64,
    "k_for_knn": 16,
    "seq_len": 2048,
    # camera intrinsics (FoVPerspectiveCameras defaults used by the reference)
    "fov_degrees": 60.0,
    "camera_znear": 1.0,
    # training
    "nbp_lr": 0.001,
    "nbp_batch_size": 56,
    "epochs": 100,
    "save_model_every_n_epoch": 3,
    "random_seed": 8,
    # NBP pipeline constants (reference train_nbp_model.py:75-77)
    "pc2img_size": [256, 256],
    "prediction_range": [-40.0, 40.0],
    "value_map_size": [64, 64],
    "n_pieces": 4,
    # rollout buffers (TPU fixed capacities; new knobs)
    "full_pc_capacity": 2_000_000,
    "points_per_frame": 6144,
    "max_path_len": 96,
}


def default_params(**overrides: Any) -> Params:
    d = dict(DEFAULT_PARAMS)
    d.update(overrides)
    return Params(d, flatten=False)


# ---------------------------------------------------------------------------
# Per-scene settings (the reference's per-scene settings.json)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SceneSettings:
    """Scene bbox and surface-store grid dims (macarons_utils.py:2152-2164)."""

    x_min: np.ndarray  # (3,) already scaled by scene_scale_factor
    x_max: np.ndarray  # (3,)
    grid_l: int
    grid_w: int
    grid_h: int
    cell_capacity: int
    cell_resolution: float


@dataclasses.dataclass
class CameraSettings:
    """Camera pose lattice dims (macarons_utils.py:2167-2184)."""

    x_min: np.ndarray  # (3,) scaled
    x_max: np.ndarray  # (3,) scaled
    pose_l: int
    pose_w: int
    pose_h: int
    pose_n_elev: int
    pose_n_azim: int
    start_positions: np.ndarray  # (n_start, 5) int
    contrast_factor: float = 1.0


@dataclasses.dataclass
class Settings:
    scene: SceneSettings
    camera: CameraSettings

    @staticmethod
    def from_dict(d: Dict[str, Any], scene_scale_factor: float = 1.0) -> "Settings":
        s = d["scene"]
        c = d["camera"]
        scene = SceneSettings(
            x_min=scene_scale_factor * np.asarray(s["x_min"], dtype=np.float32),
            x_max=scene_scale_factor * np.asarray(s["x_max"], dtype=np.float32),
            grid_l=int(s["grid_l"]),
            grid_w=int(s["grid_w"]),
            grid_h=int(s["grid_h"]),
            cell_capacity=int(s["cell_capacity"]),
            cell_resolution=float(s["cell_resolution"]),
        )
        camera = CameraSettings(
            x_min=scene_scale_factor * np.asarray(c["x_min"], dtype=np.float32),
            x_max=scene_scale_factor * np.asarray(c["x_max"], dtype=np.float32),
            pose_l=int(c["pose_l"]),
            pose_w=int(c["pose_w"]),
            pose_h=int(c["pose_h"]),
            pose_n_elev=int(c["pose_n_theta"]),
            pose_n_azim=int(c["pose_n_azim"]),
            start_positions=np.asarray(c["start_positions"], dtype=np.int64),
            contrast_factor=float(c.get("contrast_factor", 1.0)),
        )
        return Settings(scene=scene, camera=camera)

    @staticmethod
    def load(settings_json_path: str, scene_scale_factor: float = 1.0) -> "Settings":
        with open(settings_json_path, "r") as f:
            d = json.load(f)
        return Settings.from_dict(d, scene_scale_factor)

    def to_dict(self, scene_scale_factor: float = 1.0) -> Dict[str, Any]:
        """Inverse of from_dict (divides coordinates back out)."""
        inv = 1.0 / scene_scale_factor
        return {
            "scene": {
                "x_min": (inv * self.scene.x_min).tolist(),
                "x_max": (inv * self.scene.x_max).tolist(),
                "grid_l": self.scene.grid_l,
                "grid_w": self.scene.grid_w,
                "grid_h": self.scene.grid_h,
                "cell_capacity": self.scene.cell_capacity,
                "cell_resolution": self.scene.cell_resolution,
            },
            "camera": {
                "x_min": (inv * self.camera.x_min).tolist(),
                "x_max": (inv * self.camera.x_max).tolist(),
                "pose_l": self.camera.pose_l,
                "pose_w": self.camera.pose_w,
                "pose_h": self.camera.pose_h,
                "pose_n_theta": self.camera.pose_n_elev,
                "pose_n_azim": self.camera.pose_n_azim,
                "start_positions": self.camera.start_positions.tolist(),
                "contrast_factor": self.camera.contrast_factor,
            },
        }
