"""The LA and ACDC batch feed: ``bcp_tpu/data/feed.py`` for the port.

Host path (``cfg.device_data_cache`` off): a background thread builds the
next batches with numpy (two-stream indices, rot/flip, random crop;
`feed.py:116-127,258-301`) while the card runs the current step; the main
thread copies a built batch to the card from pinned memory without
waiting.

Device-store path (``cfg.device_data_cache`` on, `feed.py:164-223`): the
training volumes (LA) or slices (ACDC) live on the card
(``data.device_store``) and a batch is a handful of host draws plus crops
or gathers cut on the device. There is no
background thread on this path: the crops are issued by the thread that
asks for the batch, on its current CUDA stream, so the step that reads a
batch is ordered after the batch's crops by the stream itself and needs
no event. (A worker thread would only add launches that contend for the
interpreter with the training thread's own.) Both stages of a run share
one store through ``store_cache``.

On either path the same seed gives the JAX package's batches bit for bit,
images as (N, 1, *S) in the compute dtype, labels (N, *S) uint8. K-step
stacking (``steps_per_dispatch``) is not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.data.sampler import two_stream_batches
from bcp_tpu_torch.device import resolve_device

ACDC_PATIENTS_TO_SLICES = {
    # `patients_to_slices` (`feed.py:27-36`, `ACDC_BCP_train.py:181-191`)
    1: 32, 3: 68, 7: 136, 14: 256, 21: 396, 28: 512, 35: 664, 70: 1312,
}


def labeled_count(cfg: Config) -> int:
    """Labelled training cases: the first ``labelnum`` LA volumes, or the
    slices of the first ``labelnum`` ACDC patients."""
    if cfg.variant == "acdc":
        return ACDC_PATIENTS_TO_SLICES[cfg.labelnum]
    return cfg.labelnum


class BCPBatchFeeder:
    """Endless train batches of one stage: ``stage="pre"`` the labelled pair
    (``img_a``, ``img_b``, ``lab_a``, ``lab_b``), ``"self"`` also the two
    unlabelled sub-batches (``uimg_a``, ``uimg_b``). ``dataset`` is
    anything with ``len`` and ``sample_train(i, patch, rng)`` (which applies
    the variant's augmentation); its first :func:`labeled_count` cases are
    the labelled ones. One epoch is one pass over the labelled indices.
    With ``cfg.device_data_cache`` the dataset
    also needs ``load(i)``; ``store_cache`` is a dict shared by the feeders
    of one run, so the second stage reuses the first stage's store instead
    of uploading it again (`feed.py:71-76`)."""

    def __init__(self, cfg: Config, stage: str, dataset, device=None,
                 store_cache: Optional[dict] = None):
        if cfg.variant not in ("la", "acdc"):
            raise NotImplementedError(
                f"variant {cfg.variant!r}: the port's feed is LA's and "
                f"ACDC's (pancreas is ROADMAP A3)")
        self.cfg = cfg
        self.stage = stage
        self.dataset = dataset
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.img_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                          else torch.float32)
        n_lab = labeled_count(cfg)
        total = len(dataset)
        self.steps_per_epoch = max(n_lab // cfg.labeled_bs, 1)
        self._index_stream = two_stream_batches(
            list(range(n_lab)), list(range(n_lab, total)), cfg.batch_size,
            cfg.unlabeled_bs, seed=cfg.seed)
        self._store = None
        self.store_init_s = 0.0
        self._thread = None
        if cfg.device_data_cache:
            self._init_device_store(
                store_cache if store_cache is not None else {})
            return
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _init_device_store(self, cache: dict) -> None:
        from bcp_tpu_torch.data.device_store import (DeviceSliceStore,
                                                     DeviceVolumeStore)
        t0 = time.time()
        store = cache.get("store")
        if store is None:
            cases = range(len(self.dataset))
            if self.cfg.variant == "acdc":
                store = DeviceSliceStore.from_dataset(
                    self.dataset, cases, self.cfg.patch_size,
                    img_dtype=self.img_dtype, device=self.device)
            else:
                store = DeviceVolumeStore.from_dataset(
                    self.dataset, cases, self.cfg.patch_size, pad_extra=3,
                    img_dtype=self.img_dtype, device=self.device)
            cache["store"] = store
        self._store = store
        self.store_init_s = time.time() - t0

    def _sample_device(self, indices):
        """(images, labels) of ``indices`` from the store, consuming the
        feed's generator: LA's crop with rot90 + flip, ACDC's
        ``RandomGenerator``."""
        if self.cfg.variant == "acdc":
            return self._store.sample_batch(indices, self.rng)
        return self._store.sample_batch(indices, self.rng, rotflip=True)

    def build_device(self) -> Dict[str, torch.Tensor]:
        """The next batch cut from the device store (`feed.py:209-223`):
        the labelled samples' draws first, then the unlabelled ones', as
        the host path consumes its generator."""
        cfg = self.cfg
        lab_idx, unlab_idx = next(self._index_stream)
        sub = cfg.labeled_sub_bs
        img, lab = self._sample_device(lab_idx)
        batch = {"img_a": img[:sub], "img_b": img[sub:],
                 "lab_a": lab[:sub], "lab_b": lab[sub:]}
        if self.stage == "self":
            uimg, _ = self._sample_device(unlab_idx)
            usub = cfg.unlabeled_sub_bs
            batch["uimg_a"], batch["uimg_b"] = uimg[:usub], uimg[usub:]
        return batch

    def build(self) -> Dict[str, np.ndarray]:
        """The next batch on the host, f32 images (`feed.py:258-301`)."""
        cfg = self.cfg
        lab_idx, unlab_idx = next(self._index_stream)
        sub = cfg.labeled_sub_bs
        samples = [self.dataset.sample_train(i, cfg.patch_size, self.rng)
                   for i in lab_idx]
        batch = {}
        for key, part in (("a", samples[:sub]), ("b", samples[sub:])):
            batch[f"img_{key}"] = np.stack([s[0] for s in part])[:, None]
            batch[f"lab_{key}"] = np.stack([s[1] for s in part]).astype(
                np.uint8)
        if self.stage == "self":
            usub = cfg.unlabeled_sub_bs
            uimgs = [self.dataset.sample_train(i, cfg.patch_size,
                                               self.rng)[0]
                     for i in unlab_idx]
            batch["uimg_a"] = np.stack(uimgs[:usub])[:, None]
            batch["uimg_b"] = np.stack(uimgs[usub:])[:, None]
        return batch

    def _host_tensors(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if k.startswith(("img", "uimg")):
                t = t.to(self.img_dtype)
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def _worker(self):
        try:
            while not self._stop.is_set():
                self._queue.put(self._host_tensors(self.build()))
        except Exception as e:  # surfaced in the consumer
            self._queue.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._store is not None:
            return self.build_device()
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return {k: v.to(self.device, non_blocking=True)
                for k, v in item.items()}

    def close(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
