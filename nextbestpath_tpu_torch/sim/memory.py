"""On-disk per-scene trajectory memory (optional persistence tier).

Port of ``nextbestpath_tpu/sim/memory.py``: the same directory layout and
the same npz and json files, so a memory written by either package is read
by the other, and the same draws from ``random.Random`` and numpy, so both
packages pick the same replay frames. The reference Memory's layout
(macarons/utility/macarons_utils.py:3574-3978):

    <scene>/<memory_dir>/training/<traj_i>/{frames,surface,occupancy,depths}
    <scene>/<memory_dir>/poses.json

In the trainer frames live in device buffers during a rollout; this class
is the persistence/replay tier: it can snapshot frames (depth + pose) and
surface/occupancy states as .npz, and serve random replay batches like
get_random_batch_for_depth_model (:3768-3843, excluding the current
trajectory) and get_random_scene_for_scone_model (:3845-3978).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


class Memory:
    def __init__(self, scene_memory_paths: List[str], n_trajectories: int = 5,
                 current_epoch: int = 0):
        self.scene_memory_paths = list(scene_memory_paths)
        self.n_trajectories = n_trajectories
        self.current_epoch = current_epoch
        for path in self.scene_memory_paths:
            for t in range(n_trajectories):
                for sub in ("frames", "surface", "occupancy", "depths"):
                    os.makedirs(self.trajectory_dir(path, t, sub), exist_ok=True)

    @staticmethod
    def trajectory_dir(scene_memory_path: str, traj: int, sub: str) -> str:
        return os.path.join(scene_memory_path, "training", str(traj), sub)

    def current_trajectory(self) -> int:
        return self.current_epoch % self.n_trajectories

    def begin_trajectory(self, scene_memory_path: str) -> int:
        """Clear the current slot's stale files before a new trajectory.

        Slots are reused round-robin (current_epoch % n_trajectories); a
        shorter new trajectory would otherwise leave a tail of the previous
        occupant's frames/depths in place, and n_frames/n_depths would count
        them — replay would then mix two trajectories' data (old depths
        supervised by the new occupancy snapshot). Returns the slot."""
        traj = self.current_trajectory()
        for sub in ("frames", "depths", "surface", "occupancy"):
            d = self.trajectory_dir(scene_memory_path, traj, sub)
            for f in os.listdir(d):
                if f.endswith(".npz"):
                    os.remove(os.path.join(d, f))
        poses = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                 "frames"), "..", "poses.json")
        if os.path.exists(poses):
            os.remove(poses)
        return traj

    def get_trajectory_frames_path(self, scene_memory_path: str,
                                   traj: int) -> str:
        return self.trajectory_dir(scene_memory_path, traj, "frames")

    # -- frames -------------------------------------------------------------

    def save_frame(self, scene_memory_path: str, traj: int, frame_nb: int,
                   zbuf: np.ndarray, R: np.ndarray, T: np.ndarray,
                   zfar: float, rgb: Optional[np.ndarray] = None) -> None:
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "frames"), f"{frame_nb}.npz")
        arrays = dict(zbuf=zbuf.astype(np.float16), R=R, T=T,
                      zfar=np.asarray(zfar))
        if rgb is not None:
            arrays["rgb"] = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        np.savez_compressed(path, **arrays)

    def load_frame(self, scene_memory_path: str, traj: int,
                   frame_nb: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "frames"), f"{frame_nb}.npz")
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def n_frames(self, scene_memory_path: str, traj: int) -> int:
        d = self.trajectory_dir(scene_memory_path, traj, "frames")
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    def random_replay_frames(self, scene_memory_path: str, n_frames: int,
                             rng: Optional[random.Random] = None
                             ) -> List[Dict[str, np.ndarray]]:
        """Random frames from a NON-current trajectory (the reference raises
        'APOCALYPSE!' when replaying the current one,
        macarons_utils.py:3793-3803)."""
        rng = rng or random.Random(0)
        candidates = [
            t for t in range(self.n_trajectories)
            if t != self.current_trajectory()
            and self.n_frames(scene_memory_path, t) >= n_frames
        ]
        if not candidates:
            return []
        traj = rng.choice(candidates)
        total = self.n_frames(scene_memory_path, traj)
        start = rng.randrange(0, total - n_frames + 1)
        return [self.load_frame(scene_memory_path, traj, start + i)
                for i in range(n_frames)]

    # -- scene snapshots ----------------------------------------------------

    def save_surface(self, scene_memory_path: str, traj: int,
                     points: np.ndarray, count: int) -> None:
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "surface"), "surface.npz")
        np.savez_compressed(path, points=points[:count])

    def load_surface(self, scene_memory_path: str, traj: int) -> np.ndarray:
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "surface"), "surface.npz")
        with np.load(path) as z:
            return z["points"]

    def save_occupancy(self, scene_memory_path: str, traj: int,
                       points: np.ndarray, proba: np.ndarray,
                       supervision_occ: np.ndarray, view_states: np.ndarray,
                       out_of_field: np.ndarray) -> None:
        """Occupancy-field snapshot (save_occupancy_field_in_memory,
        macarons_utils.py:787-821): the proxy-point field's state is
        persisted per trajectory so scone replay can rebuild supervision
        without re-carving."""
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "occupancy"), "field.npz")
        np.savez_compressed(
            path, points=np.asarray(points, np.float32),
            proba=np.asarray(proba, np.float16),
            supervision_occ=np.asarray(supervision_occ, np.float16),
            view_states=np.asarray(view_states, np.float16),
            out_of_field=np.asarray(out_of_field, np.float16),
        )

    def has_occupancy(self, scene_memory_path: str, traj: int) -> bool:
        """Cheap existence check (candidate filters must not decompress
        every trajectory's snapshot just to test eligibility)."""
        return os.path.exists(
            os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                             "occupancy"), "field.npz"))

    def load_occupancy(self, scene_memory_path: str,
                       traj: int) -> Optional[Dict[str, np.ndarray]]:
        """Loader analog of load_occupancy_field_from_memory
        (macarons_utils.py:824-868). None when no snapshot exists."""
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "occupancy"), "field.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in z.files}

    def save_depth(self, scene_memory_path: str, traj: int, frame_nb: int,
                   depth: np.ndarray, R: np.ndarray, T: np.ndarray) -> None:
        """Persist a (predicted or perfect) depth map for scone replay
        (the depths/ tier written by recompute_mapping's save_depths,
        macarons_utils.py:815-1035)."""
        path = os.path.join(self.trajectory_dir(scene_memory_path, traj,
                                                "depths"), f"{frame_nb}.npz")
        np.savez_compressed(path, depth=depth.astype(np.float16), R=R, T=T)

    def n_depths(self, scene_memory_path: str, traj: int) -> int:
        d = self.trajectory_dir(scene_memory_path, traj, "depths")
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    def get_random_scene_for_scone_model(
            self, scene_memory_path: str, intr, n_frames: int = 8,
            points_per_frame: int = 2048,
            rng: Optional[random.Random] = None,
            sensor_range: float = 70.0,
            n_replay_poses: int = 0,
            device="cuda") -> Optional[Dict[str, np.ndarray]]:
        """Rebuild a full replay scene from a NON-current trajectory's saved
        depths + occupancy snapshot (get_random_scene_for_scone_model,
        macarons_utils.py:3845-3978): a random window of saved depth maps is
        backprojected into a surface point cloud; the trajectory's proxy
        field snapshot provides the supervision targets.

        When ``n_replay_poses > 0`` the last that many frames are held out of
        the base surface and returned separately as replay "new cameras"
        (the n_poses_in_memory_scene_loops depths of memory_scene_loop,
        train_macarons.py:640-693): per-frame point clouds + camera centers,
        so the caller can measure each replayed camera's true coverage gain
        against the base reconstruction and supervise SconeVis with it.

        The depth maps are unprojected on ``device`` (the card unless the
        caller asks for the CPU) and only the sampled points come back.

        Returns dict(surface (N, 3), proxy_points, proba, supervision_occ,
        view_states, out_of_field[, replay_clouds (k, m, 3), replay_valid
        (k, m), replay_cams (k, 3)]) or None when no eligible trajectory.
        """
        import torch

        from ..device import resolve_device
        from ..geometry.cameras import unproject_depth

        dev = resolve_device(device)

        rng = rng or random.Random(0)
        candidates = [
            t for t in range(self.n_trajectories)
            if t != self.current_trajectory()
            and self.n_depths(scene_memory_path, t) >= n_frames
            and self.has_occupancy(scene_memory_path, t)
        ]
        if not candidates:
            return None
        traj = rng.choice(candidates)
        total = self.n_depths(scene_memory_path, traj)
        # Sorted: the base frames must replay IN TRAJECTORY ORDER (they
        # rebuild the covered state the agent actually had) and the held-out
        # replay frames must be the LATEST of the window, matching
        # memory_scene_loop's semantics (train_macarons.py docstrings).
        picks = sorted(rng.sample(range(total), n_frames))
        frames, valids, cams = [], [], []
        d_dir = self.trajectory_dir(scene_memory_path, traj, "depths")
        for i in picks:
            with np.load(os.path.join(d_dir, f"{i}.npz")) as z:
                depth = np.asarray(z["depth"], np.float32)
                R, T = np.asarray(z["R"]), np.asarray(z["T"])
            flat_d = depth.reshape(-1)
            ok = (flat_d > 0) & (flat_d < sensor_range)
            idx = np.nonzero(ok)[0]
            # A fully-masked frame still contributes an all-invalid cloud:
            # dropping it would shift the base/held-out split and change
            # base_clouds' shape, forcing a scone_replay_step retrace per
            # distinct surviving-frame count.
            keep = (rng.sample(range(len(idx)),
                               min(points_per_frame, len(idx)))
                    if len(idx) else [])
            frames.append((depth, R, T, idx[keep]))
            valid = np.zeros((points_per_frame,), bool)
            valid[: len(keep)] = True
            valids.append(valid)
            # Camera center: eye = -T @ R^T (T = -eye @ R, cameras.py).
            cams.append((-np.asarray(T).reshape(3) @ np.asarray(R)
                         .reshape(3, 3).T).astype(np.float32))
        out = torch.zeros((len(frames), points_per_frame, 3),
                          dtype=torch.float32, device=dev)

        def t(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

        for k, (depth, R, T, rows) in enumerate(frames):
            world = unproject_depth(t(depth), t(R), t(T), intr)
            out[k, : len(rows)] = world[torch.from_numpy(rows).to(dev)]
        clouds = list(out.cpu().numpy())
        occ = self.load_occupancy(scene_memory_path, traj)
        n_base = len(clouds) - n_replay_poses
        if n_base <= 0:
            return None
        base = np.concatenate(
            [c[v] for c, v in zip(clouds[:n_base], valids[:n_base])], axis=0)
        if len(base) == 0:
            return None  # every base frame fully masked: nothing to replay
        occ["surface"] = base
        occ["proxy_points"] = occ.pop("points")
        if n_replay_poses > 0:
            occ["base_clouds"] = np.stack(clouds[:n_base])
            occ["base_valid"] = np.stack(valids[:n_base])
            occ["replay_clouds"] = np.stack(clouds[n_base:])
            occ["replay_valid"] = np.stack(valids[n_base:])
            occ["replay_cams"] = np.stack(cams[n_base:])
        return occ

    def save_poses(self, scene_memory_path: str, poses: List[List[float]],
                   traj: Optional[int] = None) -> None:
        """Full per-trajectory pose history (the reference's per-epoch pose
        dumps, train_macarons.py:1402-1410). Written into the trajectory
        slot so histories from different trajectories never overwrite each
        other; traj defaults to the current slot."""
        traj = self.current_trajectory() if traj is None else traj
        d = os.path.join(scene_memory_path, "training", str(traj))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "poses.json"), "w") as f:
            json.dump({"poses": poses}, f)

    def load_poses(self, scene_memory_path: str,
                   traj: Optional[int] = None) -> List[List[float]]:
        traj = self.current_trajectory() if traj is None else traj
        with open(os.path.join(scene_memory_path, "training", str(traj),
                               "poses.json")) as f:
            return json.load(f)["poses"]
