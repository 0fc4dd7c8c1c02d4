from .spherical import (get_cartesian_coords, get_spherical_coords,
                        sample_cameras_on_sphere)
from .cameras import (
    CameraIntrinsics,
    camera_center,
    camera_ray_from_pose_angles,
    get_camera_RT,
    look_at_rotation,
    ndc_bounds,
    ndc_tables,
    points_in_fov_mask,
    project_points,
    unproject_depth,
    view_to_world_dirs,
    world_to_view,
)
