"""KDE feature-distribution demo of the port: ``bcp_tpu/cli/kde_demo.py``
(reference `code/KDE_demo.py:66-191`).

Loads a trained ACDC U-Net of the port and walks two-stream train batches
(``labeled_bs`` labelled slices first, then unlabelled, the same sampler,
seed and crops as the JAX package). Per batch one batched forward on the
card gives the logits and the last decoder feature; pixels are flattened
to (B*H*W, f_dim) rows. For class ``--specific_class`` the demo keeps the
correctly predicted pixels of the labelled and the unlabelled half, cuts
both to ``min(n_labelled, n_unlabelled, P_NUM)``, takes each pixel's mean
over the features and plots the two Gaussian KDEs (Scott's bandwidth x
``BW_ADJUST``, seaborn's ``bw_adjust``) into
``KDE/ACDC/{f_dim}/labeled_{N}/class_{c}/kde_test_mean{pic}_{N}_{c}.png``,
drawn with numpy and written by zlib (:func:`render_curves`,
:func:`write_png`): the port needs no plotting library.

    python -m bcp_tpu_torch.cli.kde_demo --root_path DATA/ACDC --labelnum 7

:func:`run` takes the train slices as any dataset with ``len`` and
``sample_train`` (``data.datasets.SliceList`` for slices in memory).
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import List, Optional

import numpy as np
import torch
from scipy import ndimage
from scipy.stats import gaussian_kde

from bcp_tpu_torch.cli.common import load_eval_model
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.data.datasets import ACDCDataset
from bcp_tpu_torch.data.feed import labeled_count
from bcp_tpu_torch.data.sampler import TwoStreamBatchSampler
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir

# `KDE_demo.py:45-47`
P_NUM = 500
BW_ADJUST = 0.5
LINE_WIDTH = 5


def build_parser():
    p = argparse.ArgumentParser(description="KDE feature demo (CUDA)")
    p.add_argument("--root_path", type=str, default="./data/ACDC")
    p.add_argument("--exp", type=str, default="BCP")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--labelnum", type=int, default=7)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--labeled_bs", type=int, default=2)
    p.add_argument("--stage_name", type=str, default="self_train")
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
    p.add_argument("--epochs", type=int, default=3,
                   help="passes over the labeled stream (KDE_demo.py:130)")
    p.add_argument("--max_pics", type=int, default=0,
                   help="stop after this many batches (0 = no cap)")
    p.add_argument("--specific_class", type=int, default=2,
                   help="class to plot (the reference hardcodes 2, "
                        "KDE_demo.py:188)")
    p.add_argument("--out_dir", type=str, default=".",
                   help="root for the KDE/ACDC/... output tree")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--device", type=str, default="cuda")
    return p


def select_correct_pixels(pred_rows: np.ndarray, label_rows: np.ndarray,
                          cls: int, labeled_pixel: int):
    """Row indices of the correctly predicted class-``cls`` pixels of the
    two halves split at ``labeled_pixel`` (`kde_demo.py:77-89`), the
    unlabelled ones in global row numbers."""
    l_pred = np.where(pred_rows[:labeled_pixel] == cls)[0]
    u_pred = np.where(pred_rows[labeled_pixel:] == cls)[0]
    l_lab = np.where(label_rows[:labeled_pixel] == cls)[0]
    u_lab = np.where(label_rows[labeled_pixel:] == cls)[0]
    cor_l = np.intersect1d(l_pred, l_lab)
    cor_u = np.intersect1d(u_pred, u_lab) + labeled_pixel
    return cor_l, cor_u


def plot_kde(features: np.ndarray, pred_rows: np.ndarray,
             label_rows: np.ndarray, specific_c: int, f_dim: int,
             pic_num: int, labelnum: int, out_dir: str = ".") -> Optional[str]:
    """`plot_kde` (`kde_demo.py:92-137`): the saved path, or None when
    either half has fewer than 2 correct pixels (a KDE needs two)."""
    total_pixel = features.shape[0]
    labeled_pixel = int(total_pixel / 2) + 1        # `KDE_demo.py:68`
    cor_l, cor_u = select_correct_pixels(pred_rows, label_rows,
                                         specific_c, labeled_pixel)
    pixel_num = min(len(cor_l), len(cor_u), P_NUM)  # `KDE_demo.py:78`
    print(f"Total {pixel_num} pixels for class {specific_c}")
    if pixel_num < 2:
        return None
    feat_l = features[cor_l[:pixel_num]].mean(axis=1)
    feat_u = features[cor_u[:pixel_num]].mean(axis=1)

    save_dir = os.path.join(
        out_dir, "KDE", "ACDC", str(f_dim), f"labeled_{labelnum}",
        f"class_{specific_c}")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(
        save_dir, f"kde_test_mean{pic_num}_{labelnum}_{specific_c}.png")
    curves = []
    for vals, color in [(feat_l, GREEN), (feat_u, BLUE)]:
        kde = gaussian_kde(vals)
        kde.set_bandwidth(kde.factor * BW_ADJUST)   # seaborn bw_adjust
        lo, hi = vals.min(), vals.max()
        pad = 3 * kde.factor * (vals.std() or 1.0)
        xs = np.linspace(lo - pad, hi + pad, 200)
        curves.append((xs, kde(xs), color))
    write_png(path, render_curves(curves))
    print(f"Save to: {path}")
    return path


#: the figure (`KDE_demo.py:85-103`: figsize 29 x 4 at 100 dpi) and its
#: curves' colours, labelled green and unlabelled blue
FIGURE = (400, 2900)
GREEN = (0, 128, 0)
BLUE = (0, 0, 255)


def render_curves(curves, size=FIGURE, margin=(30, 40, 20, 60),
                  line_width: int = LINE_WIDTH) -> np.ndarray:
    """(H, W, 3) uint8 image of the curves ``(xs, ys, rgb)`` on shared
    axes: a white figure, a black frame, each curve a polyline
    ``line_width`` pixels wide, x over the curves' joint range and y from 0
    to their largest value. The JAX package draws the same curves with
    matplotlib, which the port does not need (no tick labels or title
    here)."""
    H, W = size
    top, bottom, right, left = margin
    img = np.full((H, W, 3), 255, np.uint8)
    x0, x1, y1 = (min(c[0].min() for c in curves),
                  max(c[0].max() for c in curves),
                  max(c[1].max() for c in curves))
    span_x, span_y = max(x1 - x0, 1e-12), max(y1, 1e-12)
    img[[top, H - bottom], left:W - right] = 0
    img[top:H - bottom + 1, [left, W - right]] = 0
    r = line_width // 2
    offsets = np.arange(-r, line_width - r)
    for xs, ys, rgb in curves:
        px = left + (xs - x0) / span_x * (W - left - right - 1)
        py = H - bottom - ys / span_y * (H - top - bottom - 1)
        steps = int(np.ceil(np.abs(np.diff(px)).sum()
                            + np.abs(np.diff(py)).sum())) + len(px)
        t = np.linspace(0, len(px) - 1, steps)
        cx = np.rint(np.interp(t, np.arange(len(px)), px)).astype(int)
        cy = np.rint(np.interp(t, np.arange(len(py)), py)).astype(int)
        for dy in offsets:
            for dx in offsets:
                img[np.clip(cy + dy, 0, H - 1),
                    np.clip(cx + dx, 0, W - 1)] = rgb
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (zlib, no filter)."""
    H, W, _ = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8),
                          img.reshape(H, W * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


@torch.no_grad()
def batch_rows(model: torch.nn.Module, images: np.ndarray,
               labels: np.ndarray, device):
    """One batched forward of (B, H, W) slices: flattened per-pixel
    (features (P, f_dim) f32, pred (P,), label (P,) int32, f_dim), batch
    order (`kde_demo.py:140-157`); labels are nearest-zoomed to the
    feature map where its size differs."""
    x = torch.from_numpy(np.ascontiguousarray(images[:, None],
                                              np.float32)).to(device)
    logits, feats = model(x)[:2]
    pred = torch.argmax(logits, dim=1).cpu().numpy()
    feats = feats.float().permute(0, 2, 3, 1).cpu().numpy()
    _, x_, y_, f_dim = feats.shape
    if labels.shape[1:] != (x_, y_):
        zoom = (1, x_ / labels.shape[1], y_ / labels.shape[2])
        labels = ndimage.zoom(labels, zoom, order=0)
    return (feats.reshape(-1, f_dim), pred.reshape(-1),
            labels.reshape(-1).astype(np.int32), f_dim)


def run(args, dataset=None, device=None) -> List[Optional[str]]:
    """The demo over ``dataset`` (default: the ACDC train slices under
    ``--root_path``); the paths ``plot_kde`` returned, one a batch."""
    device = device or args.device
    cfg = acdc_config(labelnum=args.labelnum).replace(
        root_path=args.root_path, exp=args.exp, net_type=args.model,
        num_classes=args.num_classes, snapshot_root=args.snapshot_root,
        batch_size=args.batch_size, labeled_bs=args.labeled_bs)
    ckpt = best_model_path(snapshot_dir(cfg, args.stage_name), cfg.net_type)
    model = load_eval_model(cfg, ckpt, device=device)
    ds = dataset if dataset is not None else ACDCDataset(cfg.root_path,
                                                         "train")
    n_lab = labeled_count(cfg)
    print(f"Total slices is: {len(ds)}, labeled slices is:{n_lab}")
    sampler = TwoStreamBatchSampler(
        list(range(n_lab)), list(range(n_lab, len(ds))),
        args.batch_size, args.batch_size - args.labeled_bs, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    paths = []
    for _ in range(args.epochs):
        for lab_ids, unlab_ids in sampler.epoch():
            imgs, labs = [], []
            for i in list(lab_ids) + list(unlab_ids):
                im, lb = ds.sample_train(int(i), cfg.patch_size, rng)
                imgs.append(im)
                labs.append(lb)
            feats, pred, label, f_dim = batch_rows(
                model, np.stack(imgs), np.stack(labs), device)
            paths.append(plot_kde(feats, pred, label, args.specific_class,
                                  f_dim, len(paths), args.labelnum,
                                  args.out_dir))
            if args.max_pics and len(paths) >= args.max_pics:
                return paths
    return paths


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
