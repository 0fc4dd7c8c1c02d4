from .sensor import FramePoints, PointBuffer, backproject_sample, capture_depth
from .rollout import (
    TrajectoryBuffer,
    interpolate_pose,
    move_and_capture,
    observe_current,
)
from .tables import SceneTables, build_scene_tables
from .proxy import ProxyField, camera_collides, carve_with_frame
from .surface_store import SurfaceStore, camera_coverage_gain, scene_coverage
from .memory import Memory
from .coverage_gain import predict_coverage_gain, sample_proxy_points
from .pose_validity import (
    fov_nonempty_mask,
    lattice_validity_mask,
    random_valid_pose,
    sample_valid_poses_in_range,
)
