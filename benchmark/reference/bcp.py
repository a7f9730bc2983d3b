"""The plain reference of the LA self-train stage (`LA_BCP_train.py:196-
300` of DeepMed-Lab-ECNU/BCP): the teacher's pseudo-labels with the
largest-component NMS, the bidirectional copy-paste mix, the mix losses,
SGD and the EMA, in plain PyTorch, numpy and scipy.

The inputs are worked out again from what the benchmark hands both sides
(the volumes, the seeded weights, the seed): the two-stream index stream
and the random crops with their rot90 / flip (`dataloaders/dataset.py`),
the copy-paste box (`context_mask`) and the dropouts' keep masks.
Their random numbers follow the draws the configuration's seed fixes for
the program: numpy generators seeded from (seed, stage, iteration) and a
``torch.Generator`` on the compute device, as the configuration file
records under ``draws``. Everything else is the published semantics: two
forwards a network a step, one a sub-batch (each BatchNorm normalises a
sub-batch by its own statistics), the teacher in train mode, ``mix_loss``
with ``mask_DiceLoss``, ``optim.SGD(lr, momentum 0.9, weight_decay
1e-4)``, ``update_ema_variables(model, ema_model, 0.99)`` over the
parameters.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from benchmark.reference import nets


# ------------------------------------------------------------ the feed
def index_stream(n_lab: int, n_total: int, batch: int, unlab_bs: int,
                 seed: int) -> Iterator[Tuple[List[int], List[int]]]:
    """`TwoStreamBatchSampler`: labelled indices reshuffled once an epoch,
    unlabelled ones from an endless reshuffle, one numpy generator."""
    rng = np.random.default_rng(seed)
    lab_bs = batch - unlab_bs
    primary, secondary = list(range(n_lab)), list(range(n_lab, n_total))
    upool: List[int] = []

    def take(pool, indices, n):
        while len(pool) < n:
            pool.extend(rng.permutation(indices).tolist())
        out = pool[:n]
        del pool[:n]
        return out

    while True:
        pool: List[int] = []
        for _ in range(max(n_lab // lab_bs, 1)):
            lab = take(pool, primary, lab_bs)
            yield lab, take(upool, secondary, unlab_bs)


def crop_draws(rng: np.random.Generator, idx: Sequence[int],
               shapes: Sequence[Sequence[int]], patch: Sequence[int]):
    """Per sample: rot90 count k in 0..3, flip axis in {0, 1}, then the
    crop offsets, uniform in [0, dim - patch)."""
    out = []
    for i in idx:
        k = int(rng.integers(0, 4))
        f = int(rng.integers(0, 2))
        off = [int(rng.integers(0, max(int(shapes[i][d]) - patch[d], 1)))
               for d in range(3)]
        out.append((i, off, k, f))
    return out


def cut(vol: np.ndarray, off, k: int, f: int, patch) -> np.ndarray:
    """The crop at ``off``, rotated by k quarter turns in (x, y) and
    flipped along axis f."""
    sl = tuple(slice(o, o + p) for o, p in zip(off, patch))
    return np.flip(np.rot90(vol[sl], k, (0, 1)), f)


class Feed:
    """The self-train stage's batches: (img_a, img_b, lab_a, lab_b,
    uimg_a, uimg_b) of each iteration, cut from ``volumes`` ((image,
    label) pairs) as the configuration's feed draws them."""

    def __init__(self, volumes, n_lab: int, batch: int, unlab_bs: int,
                 patch: Sequence[int], seed: int):
        self.volumes = volumes
        self.patch = tuple(patch)
        self.shapes = [v[0].shape for v in volumes]
        self.stream = index_stream(n_lab, len(volumes), batch, unlab_bs,
                                   seed)
        self.rng = np.random.default_rng(seed)

    def _cut(self, draws):
        img = np.stack([cut(self.volumes[i][0], o, k, f, self.patch)
                        for i, o, k, f in draws])
        lab = np.stack([cut(self.volumes[i][1], o, k, f, self.patch)
                        for i, o, k, f in draws])
        return img[:, None].astype(np.float32), lab.astype(np.int64)

    def next(self) -> Dict[str, np.ndarray]:
        lab_idx, unlab_idx = next(self.stream)
        img, lab = self._cut(crop_draws(self.rng, lab_idx, self.shapes,
                                        self.patch))
        uimg, _ = self._cut(crop_draws(self.rng, unlab_idx, self.shapes,
                                       self.patch))
        h, u = len(lab_idx) // 2, len(unlab_idx) // 2
        return {"img_a": img[:h], "img_b": img[h:], "lab_a": lab[:h],
                "lab_b": lab[h:], "uimg_a": uimg[:u], "uimg_b": uimg[u:]}


# ---------------------------------------------------- per-iteration draws
def mask_box(stage_seed: int, it: int, patch: Sequence[int],
             ratio: float) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """`context_mask`'s zero cuboid: int(dim * ratio) a side, its start
    uniform in [0, dim - side)."""
    rng = np.random.default_rng([stage_seed, it, 0])
    sizes = tuple(int(int(s) * ratio) for s in patch)
    starts = tuple(int(rng.integers(0, int(d) - s))
                   for d, s in zip(patch, sizes))
    return starts, sizes


def dropout_seed(stage_seed: int, it: int) -> int:
    seed = np.random.SeedSequence([stage_seed, it, 1]).generate_state(
        1, np.uint64)[0]
    return int(seed >> 1)


def keep_masks(gen: torch.Generator, drops, device) -> List[torch.Tensor]:
    """The keep mask of each dropout, (shape, p) in forward order: kept
    where ``rand(shape) < 1 - p``, the port's rule."""
    return [torch.rand(tuple(s), generator=gen, device=device) < 1.0 - p
            for s, p in drops]


# ------------------------------------------------------------- the step
def largest_cc(mask: np.ndarray) -> np.ndarray:
    """`LargestCC_pancreas`: the largest 26-connected component of a
    binary volume (the lowest label on a tie); an empty mask unchanged."""
    labels, n = scipy.ndimage.label(mask, np.ones((3, 3, 3), np.int32))
    if n == 0:
        return mask
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    return (labels == int(np.argmax(counts))).astype(mask.dtype)


def cut_mask(logits: torch.Tensor, nms: bool = True) -> torch.Tensor:
    """`get_cut_mask`: class-1 softmax >= 0.5, each sample's largest
    component."""
    m = (torch.softmax(logits, 1)[:, 1] >= 0.5).long()
    if not nms:
        return m
    host = m.cpu().numpy()
    return torch.from_numpy(np.stack([largest_cc(v) for v in host])).to(
        m.device)


def masked_dice(logits, target, mask, smooth=1e-5):
    """`mask_DiceLoss(nclass=2)`: per (sample, class) Dice over the voxels
    under ``mask``, one minus the mean."""
    p = torch.softmax(logits, 1).flatten(2)
    t = F.one_hot(target, p.shape[1]).movedim(-1, 1).flatten(2).to(p.dtype)
    m = mask.flatten(1)[:, None].to(p.dtype)
    inter = (p * t * m).sum(-1)
    union = (p * m + t * m).sum(-1)
    return 1.0 - ((2 * inter + smooth) / (union + smooth)).mean()


def mix_loss(logits, img_l, patch_l, mask, u_weight=0.5, unlab=False):
    """`mix_loss` of the LA script."""
    iw, pw = (u_weight, 1.0) if unlab else (1.0, u_weight)
    pmask = 1 - mask
    dice = masked_dice(logits, img_l, mask) * iw
    dice = dice + masked_dice(logits, patch_l, pmask) * pw
    ce_l = F.cross_entropy(logits, img_l, reduction="none")
    ce_p = F.cross_entropy(logits, patch_l, reduction="none")
    ce = iw * (ce_l * mask).sum() / (mask.sum() + 1e-16)
    ce = ce + pw * (ce_p * pmask).sum() / (pmask.sum() + 1e-16)
    return (dice + ce) / 2


def teacher(model, batch, keeps):
    """The teacher's logits: two sub-batch forwards in train mode, no
    gradient."""
    with torch.no_grad():
        n = batch["uimg_a"].shape[0]
        out = [model(batch[k], [m[i * n:(i + 1) * n] for m in keeps])
               for i, k in enumerate(("uimg_a", "uimg_b"))]
    return out


class SelfTrain:
    """The LA self-train stage from ``weights`` (a state_dict of the
    configuration's net): ``step(batch, it, device)`` makes one update
    and returns its loss; ``faults`` plants the benchmark's faults in
    this reference (``"half_batch"``: the losses over the first sample of
    each mixed pair only; ``"plab"``: the first pseudo-label inverted)."""

    def __init__(self, cfg: dict, weights, device, quantize=None,
                 faults: Sequence[str] = ()):
        self.cfg = cfg
        self.net = cfg["reference_net"]
        self.widths = cfg["widths"]
        self.model = nets.build(self.net, self.widths, quantize).to(device)
        self.model.load_state_dict(weights)
        self.model.train()
        self.ema = copy.deepcopy(self.model)
        for p in self.ema.parameters():
            p.requires_grad_(False)
        t = cfg["train"]
        self.opt = torch.optim.SGD(self.model.parameters(), lr=t["base_lr"],
                                   momentum=t["momentum"],
                                   weight_decay=t["weight_decay"])
        self.device = device
        self.faults = set(faults)
        self.gen = torch.Generator(device=device)

    def step(self, host_batch: Dict[str, np.ndarray], it: int) -> float:
        cfg, t = self.cfg, self.cfg["train"]
        dev = self.device
        dt = next(self.model.parameters()).dtype
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in host_batch.items()}
        b = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in b.items()}
        stage_seed = t["stage_seed_offset"]
        patch = tuple(cfg["patch_size"])
        starts, sizes = mask_box(self.seed + stage_seed, it, patch,
                                 t["mask_ratio"])
        mask = torch.ones(patch, device=dev, dtype=dt)
        mask[tuple(slice(s, s + n) for s, n in zip(starts, sizes))] = 0
        self.gen.manual_seed(dropout_seed(self.seed + stage_seed, it))
        nu = b["uimg_a"].shape[0] * 2
        tk = keep_masks(self.gen, nets.dropout_shapes(
            self.net, self.widths, patch, nu), dev)
        nl = b["img_a"].shape[0] * 2
        sk = keep_masks(self.gen, nets.dropout_shapes(
            self.net, self.widths, patch, nl), dev)
        ua, ub = teacher(self.ema, b, tk)
        plab_a = cut_mask(ua, t["nms"])
        plab_b = cut_mask(ub, t["nms"])
        if "plab" in self.faults:
            plab_a[0] = 1 - plab_a[0]
        m = mask[None, None]
        mixl = b["img_a"] * m + b["uimg_a"] * (1 - m)
        mixu = b["uimg_b"] * m + b["img_b"] * (1 - m)
        h = mixl.shape[0]
        out_l = self.model(mixl, [k[:h] for k in sk])
        out_u = self.model(mixu, [k[h:] for k in sk])
        lmask = mask[None].expand(b["lab_a"].shape)
        uw = t["u_weight"]
        parts = [(out_l, b["lab_a"], plab_a, False),
                 (out_u, plab_b, b["lab_b"], True)]
        if "half_batch" in self.faults:
            parts = [(o[:1], x[:1], y[:1], u) for o, x, y, u in parts]
            lmask = lmask[:1]
        loss = sum(mix_loss(o, x, y, lmask, uw, unlab=u)
                   for o, x, y, u in parts)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.grads = [p.grad.detach().clone()
                      for p in self.model.parameters()]
        self.opt.step()
        with torch.no_grad():
            a = t["ema_alpha"]
            for pt, ps in zip(self.ema.parameters(),
                              self.model.parameters()):
                pt.mul_(a).add_(ps, alpha=1 - a)
        return float(loss.detach())

    def run(self, feed: Feed, steps: int, seed: int, keep: Sequence[int]):
        """``steps`` updates from the stage's first iteration: (losses,
        first step's gradients, {it: (the student's parameters, the
        teacher's)} after each iteration in ``keep``), leaves by name."""
        self.seed = seed
        losses, first, kept = [], None, {}
        names = [n for n, _ in self.model.named_parameters()]
        for it in range(1, steps + 1):
            losses.append(self.step(feed.next(), it))
            if it == 1:
                first = dict(zip(names, self.grads))
            if it in keep:
                kept[it] = tuple(
                    {n: p.detach().clone() for n, p in m.named_parameters()}
                    for m in (self.model, self.ema))
        return losses, first, kept
