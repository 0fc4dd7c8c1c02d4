"""A copy of ``nextbestpath_tpu/utils/fastloader.py`` (numpy only).

Array-batch iterator (the FastTensorDataLoader analog,
macarons/utility/utils.py:200-261): shuffled fixed-size batches over aligned
numpy arrays without per-item collation."""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class FastArrayLoader:
    def __init__(self, *arrays: np.ndarray, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        assert arrays, "need at least one array"
        n = len(arrays[0])
        assert all(len(a) == n for a in arrays), "length mismatch"
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        idx = (self._rng.permutation(self.n) if self.shuffle
               else np.arange(self.n))
        end = (self.n // self.batch_size) * self.batch_size if self.drop_last \
            else self.n
        for start in range(0, end, self.batch_size):
            sel = idx[start: start + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)
