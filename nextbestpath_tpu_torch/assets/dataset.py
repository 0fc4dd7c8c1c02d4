"""Scene dataset: reference-format scene directories or procgen specs.

Port of ``nextbestpath_tpu/assets/dataset.py`` (SceneDataset,
macarons/utility/CustomDataset.py:313-363): each item is a scene (one .obj
and settings.json, or a ``procgen_<difficulty>_<seed>`` name) packed into
SceneAssets. ``shard_for_process`` is the DistributedSampler analog: a
rank takes every W-th scene from its rank on (macarons_utils.py:279-293).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

from ..config import Params, default_params
from .procgen import generate_scene
from .scene_assets import SceneAssets, load_scene_dir, pack_generated_scene


class SceneDataset:
    """List of scene specs -> SceneAssets on access (lazily, cached)."""

    def __init__(self, scene_names: Sequence[str], data_path: str = "",
                 params: Optional[Params] = None,
                 pad_tris_to: Optional[int] = None):
        self.scene_names = list(scene_names)
        self.data_path = data_path
        self.params = params or default_params()
        self.pad_tris_to = pad_tris_to
        self._cache = {}

    def __len__(self) -> int:
        return len(self.scene_names)

    def __getitem__(self, i: int) -> SceneAssets:
        name = self.scene_names[i]
        if name in self._cache:
            return self._cache[name]
        scene_dir = os.path.join(self.data_path, name)
        if os.path.isdir(scene_dir):
            assets = load_scene_dir(scene_dir, params=self.params,
                                    pad_tris_to=self.pad_tris_to)
        elif name.startswith("procgen_"):
            parts = name.split("_")
            assets = pack_generated_scene(
                generate_scene(parts[1], seed=int(parts[2])),
                params=self.params, pad_tris_to=self.pad_tris_to)
        else:
            raise FileNotFoundError(f"scene {name!r} not found in "
                                    f"{self.data_path!r} and not a procgen "
                                    "spec")
        self._cache[name] = assets
        return assets

    def __iter__(self) -> Iterator[SceneAssets]:
        for i in range(len(self)):
            yield self[i]

    def shard_for_process(self, process_index: int, process_count: int
                          ) -> "SceneDataset":
        """The scenes of rank ``process_index`` of ``process_count``:
        every ``process_count``-th from ``process_index`` on."""
        names = self.scene_names[process_index::process_count]
        return SceneDataset(names, self.data_path, self.params,
                            self.pad_tris_to)


def get_dataloader(train_scenes: Sequence[str], val_scenes: Sequence[str],
                   test_scenes: Sequence[str], data_path: str = "",
                   params: Optional[Params] = None):
    """(train, val, test) SceneDatasets (get_dataloader analog,
    macarons_utils.py:254-326)."""
    return (SceneDataset(train_scenes, data_path, params),
            SceneDataset(val_scenes, data_path, params),
            SceneDataset(test_scenes, data_path, params))
