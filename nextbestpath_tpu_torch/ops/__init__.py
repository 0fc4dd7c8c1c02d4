from .raytrace import (
    points_inside_mesh,
    ray_hits,
    ray_hits_ref,
    render_depth,
    render_depth_batch,
    segments_hit_mesh,
    tris_to_soa,
)
from .scatter2d import (
    binned_count_imgs,
    bucketize_bins,
    count_img,
    ego2d,
    height_bins,
    img_coords,
    plan_count_imgs,
    scatter_count_img,
    scatter_mean_img,
)
from .coverage import (
    compute_auc,
    coverage_percentage,
    masked_min_dists,
    min_dists,
    pc_similarity,
    subsample_buffer,
)
from .obstacle_map import gt_obstacle_map, plane_section_segments, rasterize_segments
from .knn import knn_indices, knn_points
from .depth_sample import grid_sample_bilinear, signed_distance_to_depth
from .view_state import (
    compute_view_harmonics,
    compute_view_state,
    normalize_points_in_prediction_box,
    view_space_permutation,
)
from .pc_collision import (
    collision_with_occupancy_field,
    segment_intersects_point_cloud,
    segment_point_distances,
)
