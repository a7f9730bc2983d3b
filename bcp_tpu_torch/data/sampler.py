"""Two- and three-stream batch composition: ``bcp_tpu/data/sampler.py``
for the port. Each two-stream batch is ``batch_size - secondary_batch_size`` labelled
indices (reshuffled once per epoch) then ``secondary_batch_size`` unlabelled
ones (an endless reshuffle), from one explicit numpy generator: the same
seed gives the JAX package's index stream. :class:`ThreeStreamBatchSampler`
is the JAX package's corrected form of the reference's unused three-stream
sampler."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


class TwoStreamBatchSampler:
    """`TwoStreamBatchSampler` (`dataloaders/dataset.py:280-307`)."""

    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        if not (self.primary_indices and self.secondary_indices
                and self.primary_batch_size > 0
                and self.secondary_batch_size > 0):
            raise ValueError("both streams need indices and a positive "
                             "batch share")
        self._rng = np.random.default_rng(seed)
        self._primary_pool: List[int] = []
        self._secondary_pool: List[int] = []

    def __len__(self) -> int:
        return max(len(self.primary_indices) // self.primary_batch_size, 1)

    def _next(self, pool: List[int], indices: List[int],
              n: int) -> List[int]:
        while len(pool) < n:
            pool.extend(self._rng.permutation(indices).tolist())
        out = pool[:n]
        del pool[:n]
        return out

    def epoch(self) -> Iterator[Tuple[List[int], List[int]]]:
        """(labelled, unlabelled) index batches of one epoch; only the
        unlabelled pool carries over between epochs."""
        self._primary_pool = []
        for _ in range(len(self)):
            lab = self._next(self._primary_pool, self.primary_indices,
                             self.primary_batch_size)
            unlab = self._next(self._secondary_pool, self.secondary_indices,
                               self.secondary_batch_size)
            yield lab, unlab


class ThreeStreamBatchSampler:
    """`ThreeStreamBatchSampler` (`sampler.py:73-126`, the reference's
    `dataset.py:310-338` with the JAX package's two repairs): each batch is
    two disjoint labelled chunks of one epoch permutation around an
    unlabelled chunk of the endless reshuffle, and ``__len__`` is the real
    batch count."""

    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, seed: int = 0):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        if not (len(self.primary_indices) >= 2 * self.primary_batch_size > 0
                and self.secondary_indices
                and self.secondary_batch_size > 0):
            raise ValueError("need two labelled chunks of the primary "
                             "indices and a positive unlabelled share")
        self._rng = np.random.default_rng(seed)
        self._secondary_pool: List[int] = []

    def __len__(self) -> int:
        return len(self.primary_indices) // (2 * self.primary_batch_size)

    def epoch(self) -> Iterator[Tuple[List[int], List[int], List[int]]]:
        """(labelled a, unlabelled, labelled b) index batches of one
        epoch."""
        perm = self._rng.permutation(self.primary_indices).tolist()
        n = self.primary_batch_size
        for i in range(len(self)):
            lab_a = perm[2 * i * n:(2 * i + 1) * n]
            lab_b = perm[(2 * i + 1) * n:(2 * i + 2) * n]
            while len(self._secondary_pool) < self.secondary_batch_size:
                self._secondary_pool.extend(
                    self._rng.permutation(self.secondary_indices).tolist())
            unlab = self._secondary_pool[:self.secondary_batch_size]
            del self._secondary_pool[:self.secondary_batch_size]
            yield lab_a, unlab, lab_b

    def __iter__(self):
        for lab_a, unlab, lab_b in self.epoch():
            yield lab_a + unlab + lab_b


def two_stream_batches(primary_indices, secondary_indices, batch_size,
                       secondary_batch_size, seed=0):
    """Endless (labelled, unlabelled) index batches across epochs."""
    sampler = TwoStreamBatchSampler(primary_indices, secondary_indices,
                                    batch_size, secondary_batch_size, seed)
    while True:
        yield from sampler.epoch()
