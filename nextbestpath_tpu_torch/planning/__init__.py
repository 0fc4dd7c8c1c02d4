from .bresenham import bresenham_obstacle_count, bresenham_obstacle_count_v
from .grid_paths import (
    DIRS,
    EDGE_COLLISION,
    EDGE_PASSABLE,
    EDGE_UNKNOWN,
    INF,
    apply_edge_memo,
    bfs_distance_field,
    extract_path,
    lattice_positions,
    layout_edge_blocked,
    pick_orientations,
)
from .candidates import (
    boltzmann_first,
    region_has_observation,
    score_candidates_test,
    score_candidates_train,
)
from .bidirectional import (
    bidirectional_grid_path,
    bidirectional_path_positions,
    pc_edge_blocked,
)
