"""Dataset readers of the port: ``bcp_tpu/data/datasets.py``'s LA, ACDC and
pancreas parts.

Same on-disk layouts and split lists as the reference:

- LA (`dataloaders/dataset.py:91-126`): <root>/train.list, <root>/test.list
  and <root>/2018LA_Seg_Training Set/<case>/mri_norm2.h5;
- ACDC (`dataloaders/dataset.py:15-50`): <root>/train_slices.list,
  <root>/val.list, <root>/test.list, one h5 per train slice under
  <root>/data/slices/ and one per volume under <root>/data/;
- pancreas (`pancreas/dataloaders.py:110-174`): <root>/train_lab.txt,
  <root>/train_unlab.txt, <root>/test.txt of h5 paths relative to <root>.

``h5py`` is imported only when a file is read; with ``cache`` read cases
stay in memory, as the JAX package's ``_VolumeCache`` keeps them.
:class:`VolumeList`, :class:`SliceList` and :class:`PancreasList` serve
cases already in memory through the same ``len`` / ``load`` /
``sample_train`` interface.
"""

from __future__ import annotations

import copy
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bcp_tpu_torch.data.transforms import (acdc_random_generator,
                                           la_train_transform,
                                           pancreas_test_transform,
                                           pancreas_train_transform)

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


class _PancreasCases:
    """The index rules of `Pancreas` (`pancreas/dataloaders.py:156-167`,
    `datasets.py:137-179`): ``oversample`` multiplies ``__len__`` (x5 for
    20 % labelled, x10 for 10 %), ``reverse`` reads index i as raw case
    ``n - (i % n) - 1``; the labelled split random-crops, the others
    centre-crop (the unlabelled stream's ``CenterCrop``,
    `pancreas/dataloaders.py:145`). ``n_raw`` is the list's length."""

    split = "train_lab"
    oversample = 1
    reverse = False

    def __len__(self):
        return self.n_raw * self.oversample

    def raw_index(self, idx: int) -> int:
        i = idx % self.n_raw
        return self.n_raw - i - 1 if self.reverse else i

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.load_raw(self.raw_index(idx))

    def sample_train(self, idx: int, patch_size, rng):
        image, label = self.load(idx)
        if self.split == "train_lab":
            return pancreas_train_transform(image, label, patch_size, rng)
        return pancreas_test_transform(image, label, patch_size)

    def variant(self, oversample: int = 1, reverse: bool = False):
        """The same cases (and read cache) under other index rules: the
        feed's four streams are variants of the two lists."""
        out = copy.copy(self)
        out.oversample, out.reverse = oversample, reverse
        return out


class PancreasDataset(_PancreasCases):
    """`Pancreas` (`pancreas/dataloaders.py:110-174`): the h5 files listed
    in ``<lists_dir>/{train_lab,train_unlab,test}.txt`` (``lists_dir``
    defaults to ``base_dir``), paths relative to ``base_dir``. Read cases
    stay in memory with ``cache`` (the JAX package's default)."""

    LISTS = {"train_lab": "train_lab.txt", "train_unlab": "train_unlab.txt",
             "test": "test.txt"}

    def __init__(self, base_dir: str, split: str,
                 lists_dir: Optional[str] = None, oversample: int = 1,
                 reverse: bool = False, cache: bool = True):
        self.base_dir = base_dir
        self.split = split
        self.rel_paths = read_list(os.path.join(lists_dir or base_dir,
                                                self.LISTS[split]))
        self.n_raw = len(self.rel_paths)
        self.oversample = oversample
        self.reverse = reverse
        self._cache = {} if cache else None

    def case_path(self, idx: int) -> str:
        return os.path.join(self.base_dir,
                            self.rel_paths[self.raw_index(idx)])

    def load_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        path = os.path.join(self.base_dir, self.rel_paths[i])
        if self._cache is None:
            return _read_h5(path)
        if i not in self._cache:
            self._cache[i] = _read_h5(path)
        return self._cache[i]


class PancreasList(_PancreasCases):
    """Pancreas cases (image, label) held in memory, read like
    :class:`PancreasDataset` of ``split`` with the same ``oversample`` and
    ``reverse`` rules."""

    def __init__(self, cases: Sequence[Tuple[np.ndarray, np.ndarray]],
                 split: str = "train_lab", oversample: int = 1,
                 reverse: bool = False):
        self.cases = list(cases)
        self.split = split
        self.n_raw = len(self.cases)
        self.oversample = oversample
        self.reverse = reverse

    def load_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.cases[i]
