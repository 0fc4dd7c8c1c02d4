from .obj_io import load_obj, save_obj
from .procgen import DIFFICULTY_GRID, GeneratedScene, generate_scene
from .sampling import (
    face_areas,
    filter_faces_in_bbox,
    grid_capacity_cap,
    sample_points_on_mesh_surface,
)
from .scene_assets import (
    SceneAssets,
    load_scene_dir,
    mirror_scene,
    pack_generated_scene,
    pack_scene,
    pad_assets_to_common,
)
from .dataset import SceneDataset, get_dataloader
from .object_dataset import (
    FrameDataset,
    ObjectDataset,
    adjust_mesh,
    adjust_mesh_diagonally,
    remove_heavy_files,
)
