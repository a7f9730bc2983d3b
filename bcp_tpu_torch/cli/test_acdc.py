"""ACDC offline evaluation CLI of the port: ``bcp_tpu/cli/test_acdc.py``
(`test_ACDC.py:82-125`).

Per class and volume (dice, jaccard, hd95, asd), averaged over the test
list, printed per class and as the mean over the classes, and written to
``performance.txt``. Runs on the card by default.

    python -m bcp_tpu_torch.cli.test_acdc --root_path DATA/ACDC --labelnum 7

Besides the JAX CLI's flags: ``--n_filters`` and ``--patch_size`` for a
checkpoint of another width or slice size, and ``--device``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bcp_tpu_torch.cli.common import (ResultWriter, case_name,
                                      load_eval_model, on_ranks, ranks)
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.data.datasets import ACDCDataset
from bcp_tpu_torch.eval.slice2d import Slice2DEvaluator
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir


def build_parser():
    p = argparse.ArgumentParser(description="ACDC BCP evaluation (CUDA)")
    p.add_argument("--root_path", type=str, default="./data/ACDC")
    p.add_argument("--exp", type=str, default="BCP")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--labelnum", type=int, default=3)
    p.add_argument("--stage_name", type=str, default="self_train")
    # a reference-layout torch .pth (overrides --snapshot_root)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
    p.add_argument("--save_result", type=int, default=0)
    # data-parallel ranks, one card each (-1: every visible card)
    p.add_argument("--num_devices", type=int, default=1)
    # first-stage width and slice size of the checkpoint (reference: 16,
    # 256x256)
    p.add_argument("--n_filters", type=int, default=None)
    p.add_argument("--patch_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_evaluator(args, device=None):
    """(cfg, evaluator) of the parsed flags, weights loaded."""
    cfg = acdc_config(labelnum=args.labelnum).replace(
        root_path=args.root_path, exp=args.exp, net_type=args.model,
        num_classes=args.num_classes, snapshot_root=args.snapshot_root,
        n_filters=args.n_filters, patch_size=tuple(args.patch_size))
    device = device or args.device
    ckpt = best_model_path(snapshot_dir(cfg, args.stage_name), cfg.net_type)
    model = load_eval_model(cfg, ckpt, torch_ckpt=args.torch_ckpt,
                            device=device)
    if mesh.is_main():
        print(f"init weight from {args.torch_ckpt or ckpt}")
    return cfg, Slice2DEvaluator(model, cfg.patch_size, cfg.num_classes,
                                 device=device)


def test_calculate_metric(args, dataset=None, device=None) -> np.ndarray:
    """Evaluate the test list (or ``dataset``: anything with ``len`` and
    ``load(i) -> (image, label)`` volumes), print and write the averages,
    and return the (classes - 1, 4) average metrics. With
    ``--save_result 1`` each volume's prediction, image and label go to
    ``<model>_predictions/{case}_{pred,img,gt}.nii.gz`` beside the stage's
    snapshot directory (float32, spacing (1, 1, 10), `test_ACDC.py:70-75`;
    a case without a name is its index, ``%02d``), written in the
    background, complete when this returns.
    With ``--num_devices N > 1`` it runs on N spawned ranks (the evaluator
    shards each volume over them); rank 0 prints, writes and returns."""
    return on_ranks(_test_rank, ranks(args), device or args.device,
                    args, dataset, device)


def _test_rank(args, dataset, device):
    cfg, evaluator = build_evaluator(args, device)
    ds = dataset if dataset is not None else ACDCDataset(cfg.root_path,
                                                         "test")
    totals = np.zeros((cfg.num_classes - 1, 4))
    pred_dir = os.path.join(
        os.path.dirname(snapshot_dir(cfg, args.stage_name)),
        f"{args.model}_predictions")
    if mesh.is_main():
        os.makedirs(pred_dir, exist_ok=True)
    loaded = []

    def _images():
        for i in range(len(ds)):
            loaded.append(ds.load(i))
            yield loaded[-1][0]

    dumps = ResultWriter(args.save_result)
    try:
        # the device runs volumes i+1..i+3 while the host scores volume i
        for i, pred in enumerate(evaluator.predict_volumes(_images())):
            image, label = loaded[i]
            if not mesh.is_main():
                continue
            totals += np.asarray(evaluator.metrics_for(pred, label))
            name = case_name(ds, i)
            dumps.write([os.path.join(pred_dir, f"{name}_{t}.nii.gz")
                         for t in ("pred", "img", "gt")],
                        (pred, image, label), spacing=(1.0, 1.0, 10.0))
    finally:
        dumps.close()
    if not mesh.is_main():
        return None
    avg = totals / len(ds)
    print([avg[c] for c in range(avg.shape[0])])
    print(avg.mean(axis=0))
    with open(os.path.join(pred_dir, "..", "performance.txt"), "w") as f:
        f.write(f"metric is {avg} \n")
        f.write(f"average metric is {avg.mean(axis=0)}\n")
    return avg


def main(argv=None):
    test_calculate_metric(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
