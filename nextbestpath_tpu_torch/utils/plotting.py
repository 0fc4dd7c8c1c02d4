"""Plotting / visualization helpers.

A copy of ``nextbestpath_tpu/utils/plotting.py`` (numpy; matplotlib is
imported inside each plot, so the module imports where it is absent).

Covers the reference's visualization surface:
- point-cloud scatter + training-curve plots (macarons/utility/
  render_utils.py:11-64, plotly there; matplotlib here — no display needed),
- 8-channel value-map heatmaps and pc top-views
  (next_best_path/utility/utils.py:363-411),
- Blender export JSONs consumed by vis_blender/blender_scripts.py
  (point_cloud.json / trajectory.json schema).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def plot_point_cloud(points: np.ndarray, path: str,
                     colors: Optional[np.ndarray] = None,
                     elev: float = 30.0, azim: float = -60.0,
                     point_size: float = 0.5, title: str = "") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    c = colors if colors is not None else points[:, 1]
    ax.scatter(points[:, 0], points[:, 2], points[:, 1], s=point_size, c=c)
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_value_map(value_map: np.ndarray, path: str) -> None:
    """8-orientation value-map heatmap grid (utils.py:363-385 analog).

    value_map: (S, S, 8) NHWC.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 4, figsize=(16, 8))
    vmin, vmax = float(value_map.min()), float(value_map.max())
    for k in range(8):
        ax = axes[k // 4][k % 4]
        im = ax.imshow(value_map[:, :, k], vmin=vmin, vmax=vmax, cmap="viridis")
        ax.set_title(f"azim {k * 45} deg")
        ax.axis("off")
    fig.colorbar(im, ax=axes, shrink=0.6)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_coverage_curves(curves: dict, path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, ys in curves.items():
        ax.plot(ys, label=name)
    ax.set_xlabel("pose")
    ax.set_ylabel("coverage")
    ax.legend()
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def export_blender_json(out_dir: str, points: np.ndarray,
                        trajectory: np.ndarray,
                        colors: Optional[np.ndarray] = None,
                        scene_name: str = "scene",
                        start_index: int = 0) -> None:
    """point_cloud.json + trajectory.json for vis_blender/render_results.py.

    Schema matches what the reference's Blender script reads
    (vis_blender/blender_scripts.py:9-34): point_cloud.json carries
    ``points`` + ``colors`` (colors default to the simulator's uniform
    gray when not given), and trajectory.json nests the camera history as
    ``{scene_name: {str(start_index): {"X_cam_history": [...]}}}``.
    """
    os.makedirs(out_dir, exist_ok=True)
    points = np.asarray(points, np.float32)
    if colors is None:
        colors = np.full_like(points, 0.8)
    pc = {"points": points.tolist(),
          "colors": np.asarray(colors, np.float32).tolist()}
    with open(os.path.join(out_dir, "point_cloud.json"), "w") as f:
        json.dump(pc, f)
    traj = {scene_name: {str(start_index): {
        "X_cam_history": np.asarray(trajectory, np.float32).tolist()}}}
    with open(os.path.join(out_dir, "trajectory.json"), "w") as f:
        json.dump(traj, f)
