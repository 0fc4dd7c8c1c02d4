"""Packed, device-ready scene assets.

Replaces the reference's per-scene load path (SceneDataset.__getitem__,
macarons/utility/CustomDataset.py:336-363; load_scene_with_texture,
macarons_utils.py:574-609; trimesh copy for collision checks,
next_best_path/utility/nbp_utils.py:502-516) with a single host-side pack:
one triangle buffer serves rendering, collision, inside tests and GT surface
sampling — there is no second "collision mesh".
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from ..config import Params, Settings, default_params
from .obj_io import load_obj
from .procgen import GeneratedScene
from .sampling import (
    filter_faces_in_bbox,
    grid_capacity_cap,
    sample_points_on_mesh_surface,
)

GRAY = 0.8  # uniform vertex color used by load_scene_with_texture (:583-597)


def mirror_scene(verts: np.ndarray, settings: Settings, mirrored_axis):
    """Mirror a scene on the given axes.

    Reference: load_scene_with_texture(mirror=True) negates the vertex
    coordinates (macarons_utils.py:574-609) and Camera/Scene bounding boxes
    swap-negate per axis (Camera.__init__ :2232-2237, Scene.__init__
    :3066-3072). Triangle winding flips with an odd number of mirrored axes;
    the double-sided ray kernel is insensitive to winding, so faces are left
    as-is.
    """
    verts = np.array(verts, copy=True)
    import copy as _copy

    settings = _copy.deepcopy(settings)
    for axis in mirrored_axis:
        verts[:, axis] = -verts[:, axis]
        for box in (settings.scene, settings.camera):
            lo, hi = box.x_min[axis], box.x_max[axis]
            box.x_min[axis], box.x_max[axis] = -hi, -lo
    return verts, settings


@dataclasses.dataclass
class SceneAssets:
    """Everything a rollout needs about one scene, as padded numpy arrays."""

    name: str
    tris: np.ndarray           # (F, 3, 3) f32 world-scale triangles (padded)
    n_tris: int                # valid triangle count (<= F)
    tri_colors: np.ndarray     # (F, 3) f32 per-face color
    gt_surface: np.ndarray     # (n_gt, 3) f32 GT surface point cloud
    gt_colors: np.ndarray      # (n_gt, 3) f32
    settings: Settings
    start_cam_idx: np.ndarray  # (5,) int64
    # Camera pose lattice (derived from settings; world scale):
    pose_origin: np.ndarray    # (3,) f32: (x_min[0], x_min[1] + 3.3, x_min[2])
    pose_l: int
    pose_h: int
    n_elev: int
    n_azim: int

    @property
    def elevations_deg(self) -> np.ndarray:
        """Elevation table: -90 + 180*(1+i)/(n+1) (macarons_utils.py:2319)."""
        i = np.arange(self.n_elev, dtype=np.float32)
        return -90.0 + 180.0 * (1.0 + i) / (self.n_elev + 1)

    @property
    def azimuths_deg(self) -> np.ndarray:
        """Azimuth table: 360*i/n (macarons_utils.py:2320)."""
        return 360.0 * np.arange(self.n_azim, dtype=np.float32) / self.n_azim

    def pose_position(self, i_l: np.ndarray, i_h: np.ndarray) -> np.ndarray:
        """Lattice grid index -> world position; spacing 3, fixed height.

        Reference Camera.__init__ (macarons_utils.py:2301,2316-2321):
        x = x_min[0] + 3*i_l, y = x_min[1] + 3.3, z = x_min[2] + 3*i_h.
        """
        i_l = np.asarray(i_l, dtype=np.float32)
        i_h = np.asarray(i_h, dtype=np.float32)
        x = self.pose_origin[0] + 3.0 * i_l
        y = np.broadcast_to(self.pose_origin[1], x.shape)
        z = self.pose_origin[2] + 3.0 * i_h
        return np.stack([x, y, z], axis=-1)

    def pose_from_idx(self, idx: np.ndarray) -> np.ndarray:
        """5-D lattice index (i_l, i_w, i_h, i_elev, i_azim) -> 5-D pose."""
        idx = np.asarray(idx)
        pos = self.pose_position(idx[..., 0], idx[..., 2])
        elev = self.elevations_deg[idx[..., 3]]
        azim = self.azimuths_deg[idx[..., 4]]
        return np.concatenate(
            [pos, np.stack([elev, azim], axis=-1).reshape(pos.shape[:-1] + (2,))],
            axis=-1,
        )


def _mirror_start_idx(idx: np.ndarray, cam_before, cam_after,
                      mirrored_axis) -> np.ndarray:
    """Map a 5-D start lattice index into the mirrored camera lattice.

    The reference reuses settings start indices verbatim on mirrored scenes
    (its setup_camera then resamples if the pose lands in a wall,
    train_macarons.py:146-157). The scan collection consumes the start
    directly, so here the start POSITION is mirrored and snapped to the
    nearest node of the mirrored lattice instead — within 1.5 units of the
    exact mirror (lattice step 3), which keeps it inside the same open
    region for any scene whose free space is wider than the lattice step.
    The orientation index is kept as-is (reference behavior).
    """
    idx = idx.copy()
    for axis in mirrored_axis:
        if axis == 1:
            continue  # camera height is fixed; no vertical lattice axis
        slot = 0 if axis == 0 else 2  # (i_l, i_w, i_h, i_elev, i_azim)
        n_pose = cam_before.pose_l if axis == 0 else cam_before.pose_h
        p = float(cam_before.x_min[axis]) + 3.0 * float(idx[slot])
        new = int(round((-p - float(cam_after.x_min[axis])) / 3.0))
        idx[slot] = int(np.clip(new, 0, n_pose - 1))
    return idx


def _pad_tris(tris: np.ndarray, pad_to: Optional[int]) -> Tuple[np.ndarray, int]:
    n = len(tris)
    if pad_to is None:
        # Pad to a multiple of 512 for kernel-friendly chunking.
        pad_to = max(512, ((n + 511) // 512) * 512)
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} < n_tris={n}")
    out = np.zeros((pad_to, 3, 3), dtype=np.float32)
    out[:n] = tris
    # Degenerate padding triangles far outside any scene so they never hit.
    out[n:] = 1e8
    return out, n


def pack_scene(
    verts: np.ndarray,
    faces: np.ndarray,
    settings: Settings,
    start_cam_idx: np.ndarray,
    name: str = "scene",
    params: Optional[Params] = None,
    pad_tris_to: Optional[int] = None,
    seed: int = 0,
    mirrored_axis=None,
) -> SceneAssets:
    """Pack a world-scale mesh + settings into SceneAssets.

    GT surface: faces fully inside the gt_scene bbox (settings bbox +-0.2,
    testers/scene.py:142-145) are area-sampled to n_gt_surface_points, then
    capped per scene-grid cell at cell capacity (fill_cells semantics).
    """
    params = params or default_params()
    rng = np.random.default_rng(seed)
    if mirrored_axis:
        cam_before = settings.camera
        verts, settings = mirror_scene(verts, settings, mirrored_axis)
        start_cam_idx = _mirror_start_idx(
            np.asarray(start_cam_idx, np.int64), cam_before,
            settings.camera, mirrored_axis)

    tris = verts[faces.astype(np.int64)]  # (F, 3, 3)
    tris_padded, n_tris = _pad_tris(tris.astype(np.float32), pad_tris_to)
    tri_colors = np.full((len(tris_padded), 3), GRAY, dtype=np.float32)

    sx_min = settings.scene.x_min - 0.2
    sx_max = settings.scene.x_max + 0.2
    inside_faces = filter_faces_in_bbox(verts, faces, sx_min, sx_max)
    gt_surface = sample_points_on_mesh_surface(
        verts, inside_faces, int(params.n_gt_surface_points), rng=rng
    )
    # Per-scene settings.json cell_capacity wins over the global default
    # (fill_cells uses the SCENE's capacity, macarons_utils.py:3000-3028) —
    # otherwise a reference-format scene dir's capacity is dead config.
    cap = int(getattr(settings.scene, "cell_capacity", 0)
              or params.surface_cell_capacity)
    gt_surface = grid_capacity_cap(
        gt_surface,
        sx_min,
        sx_max,
        (settings.scene.grid_l, settings.scene.grid_w, settings.scene.grid_h),
        cap,
        rng=rng,
    )
    gt_colors = np.full((len(gt_surface), 3), GRAY, dtype=np.float32)

    cam = settings.camera
    pose_origin = np.array(
        [cam.x_min[0], cam.x_min[1] + 3.3, cam.x_min[2]], dtype=np.float32
    )
    return SceneAssets(
        name=name,
        tris=tris_padded,
        n_tris=n_tris,
        tri_colors=tri_colors,
        gt_surface=gt_surface,
        gt_colors=gt_colors,
        settings=settings,
        start_cam_idx=np.asarray(start_cam_idx, dtype=np.int64),
        pose_origin=pose_origin,
        pose_l=cam.pose_l,
        pose_h=cam.pose_h,
        n_elev=cam.pose_n_elev,
        n_azim=cam.pose_n_azim,
    )


def pad_assets_to_common(assets_list):
    """Pad lattice dims + triangle buffers to common sizes.

    Same-shape assets let the scan rollout/collection programs (which take
    scene arrays as runtime arguments) serve every scene with ONE compiled
    executable — one remote compile instead of one per difficulty level.
    Padded lattice positions fall outside the mesh (inside == False,
    off-mesh edges unblocked but disconnected), so planning semantics are
    unchanged. GT surface clouds are NOT padded here: the coverage metric
    needs a per-consumer validity mask (BatchedScanRollout/ScanCollection
    pad them internally).
    """
    l_max = max(a.pose_l for a in assets_list)
    h_max = max(a.pose_h for a in assets_list)
    f_max = max(a.tris.shape[0] for a in assets_list)
    out = []
    for a in assets_list:
        tris, n_tris = _pad_tris(a.tris[: a.n_tris], f_max)
        colors = np.full((f_max, 3), GRAY, dtype=np.float32)
        colors[: a.n_tris] = a.tri_colors[: a.n_tris]
        out.append(dataclasses.replace(
            a, tris=tris, n_tris=n_tris, tri_colors=colors,
            pose_l=l_max, pose_h=h_max,
        ))
    return out


def pack_generated_scene(scene: GeneratedScene, params: Optional[Params] = None,
                         pad_tris_to: Optional[int] = None, seed: int = 0,
                         mirrored_axis=None) -> SceneAssets:
    name = scene.name
    if mirrored_axis:
        name = f"{name}_mirror{''.join(str(a) for a in mirrored_axis)}"
    return pack_scene(
        scene.verts,
        scene.faces,
        scene.settings,
        scene.start_cam_idx,
        name=name,
        params=params,
        pad_tris_to=pad_tris_to,
        seed=seed,
        mirrored_axis=mirrored_axis,
    )


def load_scene_dir(scene_dir: str, params: Optional[Params] = None,
                   pad_tris_to: Optional[int] = None,
                   mirrored_axis=None) -> SceneAssets:
    """Load a reference-format scene directory: one .obj + settings.json.

    Mirrors SceneDataset.__getitem__ (CustomDataset.py:336-363): coordinates
    are multiplied by params.scene_scale_factor.
    """
    params = params or default_params()
    obj_name = None
    for f in sorted(os.listdir(scene_dir)):
        if f.endswith(".obj"):
            obj_name = f
            break
    if obj_name is None:
        raise FileNotFoundError(f"no .obj in {scene_dir}")
    verts, faces = load_obj(os.path.join(scene_dir, obj_name))
    verts = verts * float(params.scene_scale_factor)
    settings = Settings.load(
        os.path.join(scene_dir, "settings.json"),
        scene_scale_factor=float(params.scene_scale_factor),
    )
    start = settings.camera.start_positions[0]
    return pack_scene(
        verts, faces, settings, start,
        name=os.path.basename(scene_dir.rstrip("/")),
        params=params, pad_tris_to=pad_tris_to, mirrored_axis=mirrored_axis,
    )
