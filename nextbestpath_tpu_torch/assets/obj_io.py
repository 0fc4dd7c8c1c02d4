"""Minimal OBJ mesh I/O (host side).

Replaces the reference's ``pytorch3d.io.load_objs_as_meshes`` +
``trimesh.load`` pair (macarons/utility/macarons_utils.py:554-609,
next_best_path/utility/nbp_utils.py:502-516) with a single numpy loader.
Only geometry is read; materials/uv are ignored (the reference renders with a
uniform gray vertex texture anyway — load_scene_with_texture:574-609).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (verts f32 [V, 3], faces i32 [F, 3]).

    Polygons with >3 vertices are fan-triangulated. Vertex indices may be
    negative (relative) per the OBJ spec.
    """
    verts = []
    faces = []
    with open(path, "r") as f:
        for raw in f:
            # Tab-delimited and indented records are valid OBJ; accepting
            # them keeps this parser's output identical to the native one
            # (obj_fast.cpp skips leading whitespace and allows 'v\\t').
            line = raw.lstrip(" \t")
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 2:
                coords = [float(parts[k]) if k < len(parts) else 0.0
                          for k in range(1, 4)]
                verts.append(tuple(coords))
            elif parts[0] == "f" and len(parts) >= 2:
                idx = []
                for tok in parts[1:]:
                    if tok.startswith("#"):
                        break
                    s = tok.split("/")[0]
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float32)
    if v.size == 0:
        v = np.zeros((0, 3), dtype=np.float32)
    f_arr = np.asarray(faces, dtype=np.int32)
    if f_arr.size == 0:
        f_arr = np.zeros((0, 3), dtype=np.int32)
    return v, f_arr


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts, dtype=np.float64):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces, dtype=np.int64):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
