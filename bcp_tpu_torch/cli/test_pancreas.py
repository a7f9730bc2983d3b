"""Pancreas offline evaluation CLI of the port:
``bcp_tpu/cli/test_pancreas.py`` (`test_model` + `test_calculate_metric`,
`pancreas/train_pancreas.py:181-187`, `pancreas/test_util.py:188-198`).

Each test volume is centre-cropped to the 96^3 patch, run through the
sliding-window evaluator (stride 16/4, one window a cropped volume) with
the argmax rule, and scored (dice, jaccard, hd95, asd), (0, 0, 0, 0) for
an empty prediction; the means over the test list are printed and
returned. Runs on the card by default.

    python -m bcp_tpu_torch.cli.test_pancreas --data_root DATA/pancreas \\
        --torch_ckpt VNet_pancreas_best_model.pth
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bcp_tpu_torch.cli.common import (ResultWriter, load_eval_model,
                                      on_ranks, ranks)
from bcp_tpu_torch.config import pancreas_config
from bcp_tpu_torch.data.datasets import PancreasDataset
from bcp_tpu_torch.data.transforms import pancreas_test_transform
from bcp_tpu_torch.eval.metrics import calculate_metric_percase
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir


def build_parser():
    p = argparse.ArgumentParser(description="Pancreas BCP evaluation (CUDA)")
    p.add_argument("--data_root", type=str, default="./data/pancreas")
    p.add_argument("--label_percent", type=int, default=20)
    p.add_argument("--stage_name", type=str, default="self_train")
    # a reference-layout torch .pth (overrides --snapshot_root)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--snapshot_root", type=str, default="./result/cutmix")
    p.add_argument("--stride_xy", type=int, default=16)
    p.add_argument("--stride_z", type=int, default=4)
    p.add_argument("--detail", type=int, default=1)
    p.add_argument("--save_result", type=int, default=0)
    # data-parallel ranks, one card each (-1: every visible card)
    p.add_argument("--num_devices", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_evaluator(args, device=None):
    """(cfg, evaluator) of the parsed flags, weights loaded."""
    cfg = pancreas_config(label_percent=args.label_percent).replace(
        root_path=args.data_root, snapshot_root=args.snapshot_root,
        stride_xy=args.stride_xy, stride_z=args.stride_z)
    device = device or args.device
    ckpt = best_model_path(snapshot_dir(cfg, args.stage_name), cfg.net_type)
    model = load_eval_model(cfg, ckpt, torch_ckpt=args.torch_ckpt,
                            device=device)
    if mesh.is_main():
        print(f"init weight from {args.torch_ckpt or ckpt}")
    return cfg, SlidingWindowEvaluator(
        model, cfg.patch_size, cfg.num_classes, cfg.stride_xy, cfg.stride_z,
        batch=cfg.eval_batch, device=device)


def test_calculate_metric(args, dataset=None, device=None) -> np.ndarray:
    """Evaluate the test list (or ``dataset``: anything with ``len`` and
    ``load(i) -> (image, label)`` volumes as read) and return the average
    (dice, jc, hd95, asd). With ``--save_result 1`` each centre-cropped
    volume's prediction, image and label go to
    ``<snapshot>/predictions/%02d_{pred,img,gt}.nii.gz`` (float32),
    written in the background, complete when this returns.
    With ``--num_devices N > 1`` it runs on N spawned ranks (the evaluator
    shards each volume over them); rank 0 prints, writes and returns."""
    return on_ranks(_test_rank, ranks(args), device or args.device,
                    args, dataset, device)


def _test_rank(args, dataset, device):
    cfg, evaluator = build_evaluator(args, device)
    ds = dataset if dataset is not None else PancreasDataset(
        cfg.root_path, "test", cache=False)
    total = np.zeros(4)
    pred_dir = os.path.join(snapshot_dir(cfg, args.stage_name),
                            "predictions")
    if args.save_result and mesh.is_main():
        os.makedirs(pred_dir, exist_ok=True)
    loaded = []

    def _images():
        for i in range(len(ds)):
            loaded.append(pancreas_test_transform(*ds.load(i),
                                                  cfg.patch_size))
            yield loaded[-1][0]

    dumps = ResultWriter(args.save_result)
    try:
        # the device runs the next volumes while the host scores volume i
        for i, pred in enumerate(evaluator.infer_cases(
                _images(), rule="argmax", depth=3)):
            image, label = loaded[i]
            if not mesh.is_main():
                continue
            m = ((0.0, 0.0, 0.0, 0.0) if pred.sum() == 0
                 else calculate_metric_percase(pred, label))
            if args.detail:
                print("%02d,\t%.5f, %.5f, %.5f, %.5f" % (i, *m))
            dumps.write([os.path.join(pred_dir, "%02d_%s.nii.gz" % (i, t))
                         for t in ("pred", "img", "gt")],
                        (pred, image, label))
            total += np.asarray(m)
    finally:
        dumps.close()
    if not mesh.is_main():
        return None
    avg = total / len(ds)
    print(f"average metric is {avg}")
    return avg


def main(argv=None):
    test_calculate_metric(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
