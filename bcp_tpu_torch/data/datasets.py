"""LA dataset reader of the port: ``bcp_tpu/data/datasets.py``'s LA part.

Same on-disk layout and split lists as the reference
(`dataloaders/dataset.py:91-126`): <root>/train.list, <root>/test.list and
<root>/2018LA_Seg_Training Set/<case>/mri_norm2.h5. ``h5py`` is imported
only when a volume is read. :class:`VolumeList` serves volumes already in
memory through the same ``len`` / ``load`` interface.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

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
    """`LAHeart` (`dataloaders/dataset.py:91-126`), test-time reads."""

    def __init__(self, base_dir: str, split: str = "train"):
        self.base_dir = base_dir
        self.cases = read_list(_split_list_path(base_dir, f"{split}.list",
                                                "LA"))

    def __len__(self):
        return len(self.cases)

    def case_path(self, idx: int) -> str:
        return os.path.join(self.base_dir, "2018LA_Seg_Training Set",
                            self.cases[idx], "mri_norm2.h5")

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return _read_h5(self.case_path(idx))


class VolumeList:
    """(image, label) volumes held in memory, read like a dataset."""

    def __init__(self, cases: Sequence[Tuple[np.ndarray, np.ndarray]]):
        self.cases = list(cases)

    def __len__(self):
        return len(self.cases)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.cases[idx]
