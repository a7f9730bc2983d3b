"""The LA, ACDC and pancreas batch feed: ``bcp_tpu/data/feed.py`` for the
port.

Host path (``cfg.device_data_cache`` off): a background thread builds the
next batches with numpy (two-stream indices, rot/flip, random crop;
`feed.py:116-127,258-301`) while the card runs the current step; the main
thread copies a built batch to the card from pinned memory without
waiting.

Pancreas (`feed.py:129-162`) zips four sequential streams, as the
reference's four DataLoaders (`train_pancreas.py:144`): the labelled list
oversampled, forwards (``lab_a``) and reversed (``lab_b``), and the
unlabelled list forwards and reversed, with ``drop_last`` and no shuffle.

Device-store path (``cfg.device_data_cache`` on, `feed.py:164-223`): the
training volumes (LA, pancreas) or slices (ACDC) live on the card
(``data.device_store``) and a batch is a handful of host draws plus crops
or gathers cut on the device. There is no
background thread on this path: the crops are issued by the thread that
asks for the batch, on its current CUDA stream, so the step that reads a
batch is ordered after the batch's crops by the stream itself and needs
no event. (A worker thread would only add launches that contend for the
interpreter with the training thread's own.) Both stages of a run share
one store through ``store_cache``.

On either path the same seed gives the JAX package's batches bit for bit,
images as (N, 1, *S) in the compute dtype, labels (N, *S) uint8. With
``stack=K`` (``steps_per_dispatch``, `feed.py:60-100`) a batch holds K
consecutive iterations' batches, leading-stacked ((K, N, 1, *S) images):
the index streams and the generator are consumed in the K = 1 order
(every labelled draw of an iteration, then its unlabelled ones, then the
next iteration's), so sub-batch j is the K = 1 feed's batch j. The host
path stacks K built batches into one copy; the store path cuts the K
iterations' crops in one pass per stream, as the JAX feeder does.

With ``side_labels`` an ACDC self-train batch also holds ``ulab_a`` /
``ulab_b``, the unlabelled slices' true labels (uint8, K-stacked too;
`feed.py:233-237,286-296,388-396`), for the trainer's image snapshots;
off (the default) the feed builds and copies nothing more.

``data_scale=N`` (`feed.py:59-80,123-140`) widens every stream by N for a
world of N ranks: the global batch is N reference batches and an epoch
(LA's and ACDC's labelled pass, pancreas' zipped streams) N times shorter.
Every rank runs the same feeder from the same seed and, with ``rank``,
keeps rows ``[r*b, (r+1)*b)`` of each stream (``mesh.shard_rows``, the
JAX package's batch sharding; on the K-stacked batch the rows of each
iteration), before the copy to its device. Without ``rank`` the feeder
yields the global batch. Under a space split (``space=(s, S)``,
``sp_devices`` S, ``data_scale`` N / S) a rank then keeps x slab
``[s*X/S, (s+1)*X/S)`` of every spatial stream, labels included
(``stream_sharding``'s ``P('data', 'space')``). The device store is a
one-device path: it is refused under any world of several ranks, as in
the JAX package (`feed.py:92-95`).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.data.sampler import two_stream_batches
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.utils.spans import span

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


def pancreas_steps_per_epoch(cfg: Config, stage: str, dataset,
                             data_scale: int = 1) -> int:
    """Batches of a pancreas epoch (`feed.py:146-153`): of the oversampled
    labelled stream in pre-train, of the shorter of it and the unlabelled
    stream in self-train (the reference zips its loaders), each stream
    ``data_scale`` times wider. ``dataset`` is the (labelled, unlabelled)
    pair of case lists."""
    lab, unlab = dataset
    n = lab.n_raw * cfg.labeled_oversample // (cfg.labeled_sub_bs
                                               * data_scale)
    if stage == "self":
        n = min(n, unlab.n_raw // (cfg.unlabeled_sub_bs * data_scale))
    return max(n, 1)


def _concat(params):
    """One crop pass's draws from K iterations' ``draw_params``."""
    return tuple(np.concatenate([p[i] for p in params])
                 for i in range(len(params[0])))


def _per_step(t: torch.Tensor, K: int) -> torch.Tensor:
    """(K * n, ...) -> (K, n, ...), a view."""
    return t.view(K, t.shape[0] // K, *t.shape[1:])


class BCPBatchFeeder:
    """Endless train batches of one stage: ``stage="pre"`` the labelled pair
    (``img_a``, ``img_b``, ``lab_a``, ``lab_b``), ``"self"`` also the two
    unlabelled sub-batches (``uimg_a``, ``uimg_b``). ``dataset`` is
    anything with ``len`` and ``sample_train(i, patch, rng)`` (which applies
    the variant's augmentation); its first :func:`labeled_count` cases are
    the labelled ones. One epoch is one pass over the labelled indices.
    Pancreas' ``dataset`` is the (labelled, unlabelled) pair of case lists
    instead (``PancreasDataset`` or ``PancreasList``) and its epoch is
    :func:`pancreas_steps_per_epoch`. With ``cfg.device_data_cache`` the
    dataset
    also needs ``load(i)``; ``store_cache`` is a dict shared by the feeders
    of one run, so the second stage reuses the first stage's store instead
    of uploading it again (`feed.py:71-76`). ``stack=K`` yields K
    iterations' batches a call, leading-stacked. ``side_labels`` adds ACDC's
    ``ulab_a`` / ``ulab_b`` to self-train batches. ``data_scale`` widens
    every stream for a world of that many data indices, ``rank`` keeps
    that data index's rows of each, and ``space`` = (s, S) space index
    s's x slab of them (module docstring)."""

    def __init__(self, cfg: Config, stage: str, dataset, device=None,
                 store_cache: Optional[dict] = None, stack: int = 1,
                 side_labels: bool = False, data_scale: int = 1,
                 rank: Optional[int] = None,
                 space: Tuple[int, int] = (0, 1)):
        if cfg.variant not in ("la", "acdc", "pancreas"):
            raise ValueError(f"unknown variant {cfg.variant!r}")
        self.cfg = cfg
        self.stage = stage
        self.side_labels = (side_labels and cfg.variant == "acdc"
                            and stage == "self")
        self.stack = max(int(stack), 1)
        self.scale = max(int(data_scale), 1)
        self.rank = rank
        self.space = space
        if space[1] > 1 and (rank is None
                             or cfg.patch_size[0] % space[1]):
            raise ValueError(f"space={space} needs the data index (rank) and "
                             f"an x extent it divides, got rank={rank}, "
                             f"patch {tuple(cfg.patch_size)}")
        if cfg.device_data_cache and self.scale * space[1] > 1:
            raise ValueError("device_data_cache is a single-device "
                             "optimisation; use the host feed with several "
                             "ranks")
        self.dataset = dataset
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.img_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                          else torch.float32)
        if cfg.variant == "pancreas":
            self._init_pancreas(dataset)
        else:
            n_lab = labeled_count(cfg)
            total = len(dataset)
            self.steps_per_epoch = max(
                n_lab // (cfg.labeled_bs * self.scale), 1)
            self._index_stream = two_stream_batches(
                list(range(n_lab)), list(range(n_lab, total)),
                cfg.batch_size * self.scale, cfg.unlabeled_bs * self.scale,
                seed=cfg.seed)
        self._store = None
        self._unlab_store = None
        self._thread = None
        if cfg.device_data_cache:
            with span("feed.store_upload"):
                self._init_device_store(
                    store_cache if store_cache is not None else {})
            return
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _init_pancreas(self, dataset) -> None:
        """The four streams of `_init_pancreas` (`feed.py:129-162`) from
        ``dataset`` = (labelled, unlabelled) case lists
        (``PancreasDataset`` or ``PancreasList``)."""
        cfg = self.cfg
        lab, unlab = dataset
        self.lab_a = lab.variant(cfg.labeled_oversample)
        self.lab_b = lab.variant(cfg.labeled_oversample, reverse=True)
        self.unlab_a = unlab.variant()
        self.unlab_b = unlab.variant(reverse=True)
        per = cfg.labeled_sub_bs * self.scale
        un = cfg.unlabeled_sub_bs * self.scale
        self.steps_per_epoch = pancreas_steps_per_epoch(cfg, self.stage,
                                                        dataset, self.scale)
        n_lab, n_unlab = len(self.lab_a), len(self.unlab_a)

        def stream():
            # sequential, no shuffle, drop_last
            # (`pancreas/dataloaders.py:185-194`), wrapped modulo
            while True:
                for i in range(self.steps_per_epoch):
                    yield ([j % n_lab for j in range(i * per, (i + 1) * per)],
                           [j % n_unlab for j in range(i * un, (i + 1) * un)])
        self._index_stream = stream()

    def _init_device_store(self, cache: dict) -> None:
        from bcp_tpu_torch.data.device_store import (DeviceSliceStore,
                                                     DeviceVolumeStore)
        if self.cfg.variant == "pancreas":
            # the raw volumes of each list; the pre stage does not build
            # the unlabelled store (`feed.py:193-205`)
            def volumes(key, cases):
                if key not in cache:
                    cache[key] = DeviceVolumeStore.from_dataset(
                        cases, range(cases.n_raw), self.cfg.patch_size,
                        pad_extra=1, img_dtype=self.img_dtype,
                        device=self.device)
                return cache[key]
            self._store = volumes("lab", self.lab_a.variant())
            if self.stage == "self":
                self._unlab_store = volumes("unlab", self.unlab_a.variant())
            return
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
        if cfg.variant == "pancreas":
            return self._build_device_pancreas(lab_idx, unlab_idx)
        sub = cfg.labeled_sub_bs
        img, lab = self._sample_device(lab_idx)
        batch = {"img_a": img[:sub], "img_b": img[sub:],
                 "lab_a": lab[:sub], "lab_b": lab[sub:]}
        if self.stage == "self":
            uimg, ulab = self._sample_device(unlab_idx)
            usub = cfg.unlabeled_sub_bs
            batch["uimg_a"], batch["uimg_b"] = uimg[:usub], uimg[usub:]
            if self.side_labels:
                batch["ulab_a"], batch["ulab_b"] = ulab[:usub], ulab[usub:]
        return batch

    def _build_device_pancreas(self, lab_idx, unlab_idx):
        """`feed.py:261-277`: stream index i is raw volume ``i % n`` in the
        forward streams and ``n - (i % n) - 1`` in the reversed ones; every
        ``lab_a`` crop draws before every ``lab_b`` crop, and the
        unlabelled volumes are centre-cropped (no draws)."""
        n = self._store.shapes.shape[0]
        img_a, lab_a = self._store.sample_batch(
            [i % n for i in lab_idx], self.rng, rotflip=False)
        img_b, lab_b = self._store.sample_batch(
            [n - (i % n) - 1 for i in lab_idx], self.rng, rotflip=False)
        batch = {"img_a": img_a, "img_b": img_b, "lab_a": lab_a,
                 "lab_b": lab_b}
        if self.stage == "self":
            nu = self._unlab_store.shapes.shape[0]
            batch["uimg_a"] = self._unlab_store.center_batch(
                [i % nu for i in unlab_idx])[0]
            batch["uimg_b"] = self._unlab_store.center_batch(
                [nu - (i % nu) - 1 for i in unlab_idx])[0]
        return batch

    def build_device_stacked(self) -> Dict[str, torch.Tensor]:
        """K iterations' batches from the device store, leading-stacked
        (`feed.py:303-448`): the K iterations' draws in the K = 1 order,
        then one crop pass per stream over all of them."""
        cfg, K = self.cfg, self.stack
        if cfg.variant == "pancreas":
            return self._build_device_stacked_pancreas()
        if cfg.variant == "acdc":
            def draw(idx):
                return self._store.draw_params(idx, self.rng)
            cut = self._store.aug_batch
        else:
            def draw(idx):
                return self._store.draw_params(idx, self.rng, rotflip=True)

            def cut(params):
                return self._store.crop_batch(params, rotflip=True)
        lab_p, unlab_p = [], []
        for _ in range(K):
            lab_idx, unlab_idx = next(self._index_stream)
            lab_p.append(draw(lab_idx))
            if self.stage == "self":
                unlab_p.append(draw(unlab_idx))
        sub, usub = cfg.labeled_sub_bs, cfg.unlabeled_sub_bs
        img, lab = (_per_step(t, K) for t in cut(_concat(lab_p)))
        batch = {"img_a": img[:, :sub], "img_b": img[:, sub:],
                 "lab_a": lab[:, :sub], "lab_b": lab[:, sub:]}
        if self.stage == "self":
            uimg, ulab = (_per_step(t, K) for t in cut(_concat(unlab_p)))
            batch["uimg_a"], batch["uimg_b"] = uimg[:, :usub], uimg[:, usub:]
            if self.side_labels:
                batch["ulab_a"] = ulab[:, :usub]
                batch["ulab_b"] = ulab[:, usub:]
        return batch

    def _build_device_stacked_pancreas(self) -> Dict[str, torch.Tensor]:
        """`feed.py:383-448`: per iteration the ``lab_a`` crops' draws,
        then the ``lab_b`` crops'; the unlabelled centre crops draw
        nothing."""
        K = self.stack
        n = self._store.shapes.shape[0]
        a_p, b_p, ua, ub = [], [], [], []
        for _ in range(K):
            lab_idx, unlab_idx = next(self._index_stream)
            a_p.append(self._store.draw_params([i % n for i in lab_idx],
                                               self.rng, rotflip=False))
            b_p.append(self._store.draw_params(
                [n - (i % n) - 1 for i in lab_idx], self.rng, rotflip=False))
            if self.stage == "self":
                nu = self._unlab_store.shapes.shape[0]
                ua += [i % nu for i in unlab_idx]
                ub += [nu - (i % nu) - 1 for i in unlab_idx]
        batch = {}
        for key, params in (("a", a_p), ("b", b_p)):
            img, lab = self._store.crop_batch(_concat(params), rotflip=False)
            batch[f"img_{key}"] = _per_step(img, K)
            batch[f"lab_{key}"] = _per_step(lab, K)
        if self.stage == "self":
            batch["uimg_a"] = _per_step(self._unlab_store.center_batch(ua)[0],
                                        K)
            batch["uimg_b"] = _per_step(self._unlab_store.center_batch(ub)[0],
                                        K)
        return batch

    def _build_pancreas(self, lab_idx, unlab_idx) -> Dict[str, np.ndarray]:
        """`feed.py:283-300`: every ``lab_a`` crop, then every ``lab_b``
        crop, then the centre-cropped unlabelled pair."""
        patch = self.cfg.patch_size
        batch = {}
        for key, ds in (("a", self.lab_a), ("b", self.lab_b)):
            samples = [ds.sample_train(i, patch, self.rng) for i in lab_idx]
            batch[f"img_{key}"] = np.stack([s[0] for s in samples])[:, None]
            batch[f"lab_{key}"] = np.stack([s[1] for s in samples]).astype(
                np.uint8)
        if self.stage == "self":
            for key, ds in (("a", self.unlab_a), ("b", self.unlab_b)):
                batch[f"uimg_{key}"] = np.stack(
                    [ds.sample_train(i, patch, self.rng)[0]
                     for i in unlab_idx])[:, None]
        return batch

    def build(self) -> Dict[str, np.ndarray]:
        """The next global batch on the host, f32 images
        (`feed.py:258-301`)."""
        cfg = self.cfg
        lab_idx, unlab_idx = next(self._index_stream)
        if cfg.variant == "pancreas":
            return self._build_pancreas(lab_idx, unlab_idx)
        sub = cfg.labeled_sub_bs * self.scale
        samples = [self.dataset.sample_train(i, cfg.patch_size, self.rng)
                   for i in lab_idx]
        batch = {}
        for key, part in (("a", samples[:sub]), ("b", samples[sub:])):
            batch[f"img_{key}"] = np.stack([s[0] for s in part])[:, None]
            batch[f"lab_{key}"] = np.stack([s[1] for s in part]).astype(
                np.uint8)
        if self.stage == "self":
            usub = cfg.unlabeled_sub_bs * self.scale
            usamples = [self.dataset.sample_train(i, cfg.patch_size,
                                                  self.rng)
                        for i in unlab_idx]
            for key, part in (("a", usamples[:usub]),
                              ("b", usamples[usub:])):
                uimg = np.stack([s[0] for s in part])
                batch[f"uimg_{key}"] = uimg[:, None]
                if self.side_labels:
                    batch[f"ulab_{key}"] = np.stack(
                        [s[1] for s in part]).astype(np.uint8)
        return batch

    def _host_tensors(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            if self.rank is not None:
                # this rank's rows of the stream (of each iteration's)
                b = v.shape[self.stack > 1] // self.scale
                v = (v[:, self.rank * b:(self.rank + 1) * b]
                     if self.stack > 1 else
                     v[self.rank * b:(self.rank + 1) * b])
            s, S = self.space
            if S > 1:
                # this rank's x slab: (N, 1, X, ...) images, (N, X, ...)
                # labels, after a leading K when stacked
                axis = (1 if k.startswith(("lab", "ulab")) else 2) + (
                    self.stack > 1)
                n = v.shape[axis] // S
                v = v[(slice(None),) * axis + (slice(s * n, (s + 1) * n),)]
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k.startswith(("img", "uimg")):
                t = t.to(self.img_dtype)
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def build_stacked(self) -> Dict[str, np.ndarray]:
        """K batches of :meth:`build`, leading-stacked (`feed.py:455-459`)."""
        built = [self.build() for _ in range(self.stack)]
        return {k: np.stack([b[k] for b in built]) for k in built[0]}

    def _worker(self):
        build = self.build if self.stack == 1 else self.build_stacked
        try:
            while not self._stop.is_set():
                self._queue.put(self._host_tensors(build()))
        except Exception as e:  # surfaced in the consumer
            self._queue.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        with span("feed.batch"):
            if self._store is not None:
                return (self.build_device() if self.stack == 1
                        else self.build_device_stacked())
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
