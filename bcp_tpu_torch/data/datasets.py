"""LA dataset reader of the port: ``bcp_tpu/data/datasets.py``'s LA part.

Same on-disk layout and split lists as the reference
(`dataloaders/dataset.py:91-126`): <root>/train.list, <root>/test.list and
<root>/2018LA_Seg_Training Set/<case>/mri_norm2.h5. ``h5py`` is imported
only when a volume is read; train volumes stay cached in memory after the
first read, as the JAX package's ``_VolumeCache`` does. :class:`VolumeList`
serves volumes already in memory through the same ``len`` / ``load`` /
``sample_train`` interface.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from bcp_tpu_torch.data.transforms import la_train_transform

#: the port's copies of the reference's `data_split/` lists
VENDORED_SPLITS = os.path.join(os.path.dirname(__file__), "splits")


def read_list(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def _split_list_path(base_dir: str, name: str, dataset: str) -> str:
    """The data root's list first (the reference's layout), else the
    vendored copy; a missing list names the expected location."""
    primary = os.path.join(base_dir, name)
    if os.path.exists(primary):
        return primary
    vendored = os.path.join(VENDORED_SPLITS, dataset, name)
    if os.path.exists(vendored):
        return vendored
    return primary


def _read_h5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py
    with h5py.File(path, "r") as f:
        return f["image"][:], f["label"][:]


class LAHeartDataset:
    """`LAHeart` (`dataloaders/dataset.py:91-126`). ``cache`` keeps read
    volumes in memory (the train split, read every step)."""

    def __init__(self, base_dir: str, split: str = "train",
                 cache: bool = False):
        self.base_dir = base_dir
        self.cases = read_list(_split_list_path(base_dir, f"{split}.list",
                                                "LA"))
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.cases)

    def case_path(self, idx: int) -> str:
        return os.path.join(self.base_dir, "2018LA_Seg_Training Set",
                            self.cases[idx], "mri_norm2.h5")

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is None:
            return _read_h5(self.case_path(idx))
        if idx not in self._cache:
            self._cache[idx] = _read_h5(self.case_path(idx))
        return self._cache[idx]

    def sample_train(self, idx: int, patch_size, rng):
        """`LAHeartDataset.sample_train` (`datasets.py:98-100`)."""
        image, label = self.load(idx)
        return la_train_transform(image, label, patch_size, rng)


class VolumeList:
    """(image, label) volumes held in memory, read like a dataset."""

    def __init__(self, cases: Sequence[Tuple[np.ndarray, np.ndarray]]):
        self.cases = list(cases)

    def __len__(self):
        return len(self.cases)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.cases[idx]

    def sample_train(self, idx: int, patch_size, rng):
        image, label = self.load(idx)
        return la_train_transform(image, label, patch_size, rng)
