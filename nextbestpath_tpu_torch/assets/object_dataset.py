"""Object-mesh and frame-sequence datasets (the legacy data tier).

A copy of ``nextbestpath_tpu/assets/object_dataset.py`` (numpy only).

The reference keeps three dataset generations alongside SceneDataset
(macarons/utility/CustomDataset.py): ``CustomDataset`` (:23-95) and
``CustomShapenetDataset`` (:97-164) walk a directory tree for .obj models,
drop files over a size threshold, optionally persist the model list as JSON,
and normalize vertices on load; ``RGBDataset`` (:166-310) indexes saved
frame sequences per scene/trajectory for the standalone depth trainer,
exposing temporal-neighbor lookups (``get_neighbor_frame``) for the
cost-volume warps.

This module provides the same capabilities over this build's formats: .obj
via the native-or-python parser (assets/obj_io.py) and frames as the .npz
dicts the Memory tier writes (sim/memory.py). Normalization helpers mirror
macarons/utility/utils.py: ``adjust_mesh`` (:613-630, per-axis centering +
max-extent scaling over sqrt(3)) and ``adjust_mesh_diagonally`` (:633-650,
bbox-center + diagonal scaling); ``remove_heavy_files`` (:501-507).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def remove_heavy_files(file_paths: Sequence[str],
                       memory_threshold: float) -> List[str]:
    """Drop files whose on-disk size reaches the threshold (bytes)
    (remove_heavy_files, utils.py:501-507)."""
    return [p for p in file_paths
            if os.path.getsize(p) < memory_threshold]


def adjust_mesh(verts: np.ndarray, verts_range: float = 1.0) -> np.ndarray:
    """Center each axis on its own extent and scale so the largest extent
    spans verts_range / sqrt(3) (adjust_mesh, utils.py:613-630)."""
    verts = np.asarray(verts, np.float32)
    mins = verts.min(axis=0)
    maxs = verts.max(axis=0)
    extent = maxs - mins
    centered = verts - mins - extent / 2.0
    max_extent = float(extent.max())
    return centered * verts_range / (np.sqrt(3) * max(max_extent, 1e-12))


def adjust_mesh_diagonally(verts: np.ndarray,
                           diag_range: float = 1.0) -> np.ndarray:
    """Center on the bbox center and scale the bbox diagonal to diag_range
    (adjust_mesh_diagonally, utils.py:633-650)."""
    verts = np.asarray(verts, np.float32)
    mins = verts.min(axis=0)
    maxs = verts.max(axis=0)
    diag = float(np.linalg.norm(maxs - mins))
    center = (mins + maxs) / 2.0
    return (verts - center) * diag_range / max(diag, 1e-12)


class ObjectDataset:
    """Directory-walking .obj dataset (CustomDataset:23-95 and
    CustomShapenetDataset:97-164 — the two differ only in normalization
    mode, merged here behind ``adjust_diagonally``).

    Items are dicts {verts (V, 3) f32 normalized, faces (F, 3) i32, path}
    (the reference's texture atlas fields are omitted: this build's shading
    is the headlight-Lambert renderer over untextured geometry, documented
    in PARITY.md).
    """

    def __init__(self, data_path: str, memory_threshold: float = float("inf"),
                 save_to_json: bool = False, load_from_json: bool = False,
                 json_name: str = "models_list.json",
                 adjust_diagonally: bool = False, load_obj: bool = True):
        self.data_path = data_path
        self.adjust_diagonally = adjust_diagonally
        self.load_obj = load_obj
        if load_from_json:
            with open(json_name) as f:
                listed = json.load(f)["models"]
            models = [os.path.join(data_path, p) for p in listed]
        else:
            models = []
            for dirpath, _dirnames, filenames in os.walk(data_path):
                for filename in sorted(filenames):
                    if filename.endswith(".obj"):
                        models.append(os.path.join(dirpath, filename))
            models = remove_heavy_files(models, memory_threshold)
        if save_to_json:
            rel = [os.path.relpath(p, data_path) for p in models]
            with open(json_name, "w") as f:
                json.dump({"models": rel}, f)
        self.models: List[str] = list(models)

    def __len__(self) -> int:
        return len(self.models)

    def __getitem__(self, idx: int) -> Dict:
        from .obj_io import load_obj

        path = self.models[idx]
        model: Dict = {"path": path}
        if self.load_obj:
            verts, faces = load_obj(path)
            if self.adjust_diagonally:
                verts = adjust_mesh_diagonally(verts)
            else:
                verts = adjust_mesh(verts)
            model["verts"] = np.asarray(verts, np.float32)
            model["faces"] = np.asarray(faces, np.int32)
        return model


class FrameDataset:
    """Saved frame sequences with temporal-neighbor access (RGBDataset,
    CustomDataset.py:166-310).

    Layout: ``<data_path>/<scene>/<images_subdir>/<trajectory>/<n>.npz``
    (the Memory tier's frame files; the reference reads the analogous .pt
    tree). A frame is indexed iff it has ``alpha_max`` past frames in its
    trajectory and — when ``use_future_images`` — alpha_max future ones
    (:212-218), and is not listed in the frames-to-remove file (a JSON list
    of ``scene/images/traj/n`` short paths; the reference's torch-pickled
    dict, :189 — absent file means nothing removed).
    """

    def __init__(self, data_path: str, alpha_max: int,
                 use_future_images: bool = False,
                 scene_names: Optional[Sequence[str]] = None,
                 images_subdir: str = "images",
                 frames_to_remove_json: str = "frames_to_remove.json"):
        self.data_path = data_path
        self.alpha_max = alpha_max
        self.use_future_images = use_future_images
        remove_path = os.path.join(data_path, frames_to_remove_json)
        removed = set()
        if os.path.exists(remove_path):
            with open(remove_path) as f:
                removed = set(json.load(f))
        if scene_names is None:
            scene_names = sorted(
                d for d in os.listdir(data_path)
                if os.path.isdir(os.path.join(data_path, d)))
        self.index: List[Dict] = []       # flat idx -> {scene, traj, frame}
        self._paths: Dict[str, str] = {}  # "scene/traj/frame" -> file path
        for scene in scene_names:
            scene_dir = os.path.join(data_path, scene, images_subdir)
            if not os.path.isdir(scene_dir):
                continue
            for traj in sorted(os.listdir(scene_dir)):
                traj_dir = os.path.join(scene_dir, traj)
                frames = sorted(
                    int(f.split(".")[0]) for f in os.listdir(traj_dir)
                    if f.endswith(".npz"))
                n = len(frames)
                for fn in frames:
                    key = f"{scene}/{traj}/{fn}"
                    self._paths[key] = os.path.join(traj_dir, f"{fn}.npz")
                    short = f"{scene}/{images_subdir}/{traj}/{fn}.npz"
                    eligible = fn >= self.alpha_max and (
                        (not use_future_images)
                        or fn < n - self.alpha_max)
                    if eligible and short not in removed:
                        self.index.append(
                            {"scene": scene, "traj": traj, "frame": fn})

    def __len__(self) -> int:
        return len(self.index)

    def _load(self, scene: str, traj: str, frame: int) -> Dict:
        path = self._paths[f"{scene}/{traj}/{frame}"]
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
        out["path"] = path
        return out

    def __getitem__(self, idx: int) -> Dict:
        e = self.index[idx]
        frame = self._load(e["scene"], e["traj"], e["frame"])
        frame["index"] = idx
        return frame

    def get_neighbor_frame(self, idx: int, alpha: int) -> Dict:
        """Frame at temporal offset ``alpha`` within the same trajectory
        (get_neighbor_frame_from_idx, CustomDataset.py:292-310). The
        alpha_max eligibility margin guarantees existence for
        |alpha| <= alpha_max (past; future too with use_future_images)."""
        e = self.index[idx]
        frame = self._load(e["scene"], e["traj"], e["frame"] + alpha)
        frame["index"] = idx
        return frame
