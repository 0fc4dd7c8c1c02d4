"""Experience replay store (host side, numpy).

Port of ``nextbestpath_tpu/train/replay.py``, with its npz layout, so that
each package reads the other's files. One entry:

    model_input  (5, S, S) f16   (counts < 2048 are exact in f16)
    gt_layout    (S, S)    u8    (binary)
    pixels       (k, 3)    i32   (rot, row, col)
    gains        (k,)      f32
    pose_i       int

An npz holds ``n`` and, per entry i, ``mi_i``, ``gl_i``, ``px_i``, ``gn_i``
and ``pi_i``. The readers follow the reference's sampling: every-Nth entry
moved out as validation (``extract_validation``), and the newest ``last_n``
entries plus a random sample of the older ones (``read_combined``).
``save_native`` / ``load_native`` go through the native record store
(``replay_native.py``), one record an experience, in the JAX package's
record format.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Experience:
    model_input: np.ndarray   # (5, S, S) f16
    gt_layout: np.ndarray     # (S, S) u8
    pixels: np.ndarray        # (k, 3) i32
    gains: np.ndarray         # (k,) f32
    pose_i: int


def _read_npz(path: str) -> List[Experience]:
    with np.load(path) as z:
        return [Experience(model_input=z[f"mi_{i}"], gt_layout=z[f"gl_{i}"],
                           pixels=z[f"px_{i}"], gains=z[f"gn_{i}"],
                           pose_i=int(z[f"pi_{i}"]))
                for i in range(int(z["n"]))]


class ReplayDB:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: List[Experience] = []
        if path and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self.entries)

    def append(self, model_input: np.ndarray, gt_layout: np.ndarray,
               pixels: np.ndarray, gains: np.ndarray, pose_i: int) -> None:
        mi = np.asarray(model_input, np.float16)
        gl = np.asarray(gt_layout, np.uint8)
        if mi.ndim != 3 or mi.shape[0] != 5 or gl.shape != mi.shape[1:]:
            raise ValueError(f"an experience is a (5, S, S) input and an "
                             f"(S, S) layout, not {mi.shape} and {gl.shape}")
        self.entries.append(Experience(
            model_input=mi, gt_layout=gl,
            pixels=np.asarray(pixels, np.int32).reshape(-1, 3),
            gains=np.asarray(gains, np.float32).reshape(-1),
            pose_i=int(pose_i)))

    def extract_validation(self, num: int = 1200) -> List[Experience]:
        """Move every-Nth entry out into a validation set, N =
        max(ceil(len / num), 4): the minimum stride keeps most of a small
        run's entries for training."""
        if not self.entries:
            return []
        n = max(math.ceil(len(self.entries) / num), 4)
        val, keep = [], []
        for i, e in enumerate(self.entries):
            if i % n == 0 and len(val) < num:
                val.append(e)
            else:
                keep.append(e)
        self.entries = keep
        return val

    def read_combined(self, last_n: int = 4608, sample_size: int = 4352,
                      rng: Optional[random.Random] = None
                      ) -> List[Experience]:
        """The newest last_n entries after a random sample_size of the
        older ones (``rng.sample``, as the JAX store draws it)."""
        rng = rng or random.Random(0)
        if last_n is None or len(self.entries) <= last_n:
            return list(self.entries)
        old = self.entries[:-last_n]
        sampled = rng.sample(old, min(sample_size, len(old)))
        return sampled + self.entries[-last_n:]

    # -- persistence ------------------------------------------------------

    @staticmethod
    def _pack(entries: List[Experience]) -> Dict[str, Any]:
        arrays: Dict[str, Any] = {"n": np.asarray(len(entries))}
        for i, e in enumerate(entries):
            arrays[f"mi_{i}"] = e.model_input
            arrays[f"gl_{i}"] = e.gt_layout
            arrays[f"px_{i}"] = e.pixels
            arrays[f"gn_{i}"] = e.gains
            arrays[f"pi_{i}"] = np.asarray(e.pose_i)
        return arrays

    def save_entries(self, path: str, entries: List[Experience]) -> None:
        """Write a list of entries as one uncompressed npz."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **self._pack(entries))

    def save_epoch(self, db_dir: str, epoch: int, start: int) -> int:
        """Write entries[start:] as <db_dir>/epoch_<epoch:04d>.npz; returns
        the new high-water mark."""
        self.save_entries(os.path.join(db_dir, f"epoch_{epoch:04d}.npz"),
                          self.entries[start:])
        return len(self.entries)

    def load_dir(self, db_dir: str, max_epoch: Optional[int] = None) -> int:
        """Append the epoch_*.npz shards of db_dir in name order, skipping
        shards of epochs after max_epoch (a resume's leftovers); returns
        the count loaded."""
        if not os.path.isdir(db_dir):
            return 0
        n_loaded = 0
        for fname in sorted(os.listdir(db_dir)):
            if not (fname.startswith("epoch_") and fname.endswith(".npz")):
                continue
            if max_epoch is not None:
                try:
                    shard_epoch = int(fname[len("epoch_"):-len(".npz")])
                except ValueError:
                    shard_epoch = None
                if shard_epoch is not None and shard_epoch > max_epoch:
                    continue
            loaded = _read_npz(os.path.join(db_dir, fname))
            self.entries.extend(loaded)
            n_loaded += len(loaded)
        return n_loaded

    def save(self, path: Optional[str] = None) -> None:
        """The whole store as one uncompressed npz at path (default: the
        store's own)."""
        path = path or self.path
        if path is None:
            raise ValueError("ReplayDB.save needs a path")
        self.save_entries(path, self.entries)

    def load(self, path: str) -> None:
        self.entries = _read_npz(path)

    def save_native(self, path: str) -> None:
        """Append the entries the native store at path does not hold yet,
        one record each (JAX ``ReplayDB.save_native``)."""
        from .replay_native import NativeReplayStore

        store = NativeReplayStore(path)
        for i in range(len(store), len(self.entries)):
            store.append(self.entries[i])
        store.close()

    def load_native(self, path: str) -> int:
        """Append every record of the native store at path; returns the
        count."""
        from .replay_native import NativeReplayStore

        store = NativeReplayStore(path)
        loaded = store.read_all()
        self.entries.extend(loaded)
        store.close()
        return len(loaded)
