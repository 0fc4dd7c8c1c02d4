"""Curriculum schedules for online occupancy supervision.

A copy of ``nextbestpath_tpu/sim/curriculum.py`` (numpy only): ports of
get_curriculum_sampling_distances / get_curriculum_sampling_cell_number
(macarons/utility/macarons_utils.py:1744-1764). Early in a trajectory the
occupancy supervision concentrates near observed surface (small sampling
distance, few cells); by the end it spreads over the whole scene. The
distance ramp is a normalized arctan; the cell count is linear 5 -> 20.
"""

from __future__ import annotations

import numpy as np


def curriculum_sampling_distances(n_poses: int, min_distance: float,
                                  max_distance: float) -> np.ndarray:
    """(n_poses,) arctan ramp from min to max sampling distance
    (macarons_utils.py:1744-1754). min = 3 x proxy spacing, max = 2 x scene
    cell diagonal at the reference call site."""
    x = np.arctan(10.0 * (np.linspace(0.0, 1.0, n_poses) - 0.5))
    x -= x.min()
    x /= x.max()
    return min_distance + x * (max_distance - min_distance)


def curriculum_sampling_cell_number(n_poses: int, min_cells: int = 5,
                                    max_cells: int = 20) -> np.ndarray:
    """(n_poses,) linear cell-count ramp (macarons_utils.py:1757-1764)."""
    n = min_cells + np.linspace(0.0, 1.0, n_poses) * (max_cells - min_cells)
    return np.floor(n).astype(int)
