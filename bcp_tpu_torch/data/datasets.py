"""Dataset readers of the port: ``bcp_tpu/data/datasets.py``'s LA and ACDC
parts.

Same on-disk layouts and split lists as the reference:

- LA (`dataloaders/dataset.py:91-126`): <root>/train.list, <root>/test.list
  and <root>/2018LA_Seg_Training Set/<case>/mri_norm2.h5;
- ACDC (`dataloaders/dataset.py:15-50`): <root>/train_slices.list,
  <root>/val.list, <root>/test.list, one h5 per train slice under
  <root>/data/slices/ and one per volume under <root>/data/.

``h5py`` is imported only when a file is read; with ``cache`` read cases
stay in memory, as the JAX package's ``_VolumeCache`` keeps them.
:class:`VolumeList` and :class:`SliceList` serve cases already in memory
through the same ``len`` / ``load`` / ``sample_train`` interface.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bcp_tpu_torch.data.transforms import (acdc_random_generator,
                                           la_train_transform)

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


class _H5Cases:
    """``load(i)`` of the h5 file ``case_path(i)``, kept in memory after
    the first read when ``cache`` is on (the train split, read every
    step)."""

    def __init__(self, cache: bool):
        self._cache = {} if cache else None

    def __len__(self):
        return len(self.cases)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is None:
            return _read_h5(self.case_path(idx))
        if idx not in self._cache:
            self._cache[idx] = _read_h5(self.case_path(idx))
        return self._cache[idx]


class LAHeartDataset(_H5Cases):
    """`LAHeart` (`dataloaders/dataset.py:91-126`)."""

    def __init__(self, base_dir: str, split: str = "train",
                 cache: bool = False):
        super().__init__(cache)
        self.base_dir = base_dir
        self.cases = read_list(_split_list_path(base_dir, f"{split}.list",
                                                "LA"))

    def case_path(self, idx: int) -> str:
        return os.path.join(self.base_dir, "2018LA_Seg_Training Set",
                            self.cases[idx], "mri_norm2.h5")

    def sample_train(self, idx: int, patch_size, rng):
        """`LAHeartDataset.sample_train` (`datasets.py:98-100`)."""
        image, label = self.load(idx)
        return la_train_transform(image, label, patch_size, rng)


class ACDCDataset(_H5Cases):
    """`BaseDataSets` (`dataloaders/dataset.py:15-50`; `datasets.py:103-
    134`): ``split="train"`` reads one 2-D slice a case, ``"val"`` and
    ``"test"`` one (slices, H, W) volume a case. ``num`` keeps the first
    ``num`` train slices."""

    LISTS = {"train": "train_slices.list", "val": "val.list",
             "test": "test.list"}

    def __init__(self, base_dir: str, split: str = "train",
                 num: Optional[int] = None, cache: bool = False):
        super().__init__(cache)
        self.base_dir = base_dir
        self.split = split
        self.cases = read_list(_split_list_path(base_dir, self.LISTS[split],
                                                "ACDC"))
        if num is not None and split == "train":
            self.cases = self.cases[:num]

    def case_path(self, idx: int) -> str:
        case = self.cases[idx]
        if self.split == "train":
            return os.path.join(self.base_dir, "data", "slices",
                                f"{case}.h5")
        return os.path.join(self.base_dir, "data", f"{case}.h5")

    def sample_train(self, idx: int, patch_size, rng):
        """`ACDCDataset.sample_train` (`datasets.py:131-134`)."""
        image, label = self.load(idx)
        return acdc_random_generator(image, label, patch_size, rng)


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


class SliceList(VolumeList):
    """ACDC train slices (image, label) held in memory, read like
    :class:`ACDCDataset`'s train split."""

    def sample_train(self, idx: int, patch_size, rng):
        image, label = self.load(idx)
        return acdc_random_generator(image, label, patch_size, rng)
