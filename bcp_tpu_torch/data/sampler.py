"""Two-stream batch composition: ``bcp_tpu/data/sampler.py`` :22-70,129 for
the port. Each batch is ``batch_size - secondary_batch_size`` labelled
indices (reshuffled once per epoch) then ``secondary_batch_size`` unlabelled
ones (an endless reshuffle), from one explicit numpy generator: the same
seed gives the JAX package's index stream."""

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


def two_stream_batches(primary_indices, secondary_indices, batch_size,
                       secondary_batch_size, seed=0):
    """Endless (labelled, unlabelled) index batches across epochs."""
    sampler = TwoStreamBatchSampler(primary_indices, secondary_indices,
                                    batch_size, secondary_batch_size, seed)
    while True:
        yield from sampler.epoch()
