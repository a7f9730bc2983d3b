"""LA offline evaluation CLI of the port: ``bcp_tpu/cli/test_la.py``.

Per-case (dice, jaccard, hd95, asd) lines, the dataset average and
``performance.txt``, with optional largest-CC NMS (`test_all_case`,
`utils/test_3d_patch.py:41-79`). Runs on the card by default.

    python -m bcp_tpu_torch.cli.test_la --root_path DATA/LA \\
        --torch_ckpt VNet_best_model.pth
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bcp_tpu_torch.cli.common import (ResultWriter, load_eval_model,
                                      on_ranks, ranks)
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.data.datasets import LAHeartDataset
from bcp_tpu_torch.eval.metrics import (calculate_metric_percase,
                                        host_largest_cc)
from bcp_tpu_torch.eval.sliding_window import SlidingWindowEvaluator
from bcp_tpu_torch.parallel import mesh
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir


def build_parser():
    p = argparse.ArgumentParser(description="LA BCP evaluation (CUDA)")
    p.add_argument("--root_path", type=str, default="./data/LA")
    p.add_argument("--exp", type=str, default="BCP")
    p.add_argument("--model", type=str, default="VNet")
    p.add_argument("--detail", type=int, default=1)
    p.add_argument("--nms", type=int, default=1)
    p.add_argument("--save_result", type=int, default=0)
    p.add_argument("--labelnum", type=int, default=4)
    p.add_argument("--stage_name", type=str, default="self_train")
    # a reference-layout torch .pth (overrides --snapshot_root)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
    p.add_argument("--stride_xy", type=int, default=18)
    p.add_argument("--stride_z", type=int, default=4)
    p.add_argument("--eval_batch", type=int, default=8)
    # data-parallel ranks, one card each (-1: every visible card)
    p.add_argument("--num_devices", type=int, default=1)
    p.add_argument("--patch_size", type=int, nargs=3,
                   default=[112, 112, 80])
    # first-stage width of the trained checkpoint (reference: 16)
    p.add_argument("--n_filters", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p


def build_evaluator(args, device=None):
    """(cfg, evaluator) of the parsed flags, weights loaded."""
    cfg = la_config(labelnum=args.labelnum).replace(
        root_path=args.root_path, exp=args.exp, net_type=args.model,
        snapshot_root=args.snapshot_root, stride_xy=args.stride_xy,
        stride_z=args.stride_z, eval_batch=args.eval_batch,
        patch_size=tuple(args.patch_size), n_filters=args.n_filters)
    device = device or args.device
    ckpt = best_model_path(snapshot_dir(cfg, args.stage_name), cfg.net_type)
    model = load_eval_model(cfg, ckpt, torch_ckpt=args.torch_ckpt,
                            device=device)
    if mesh.is_main():
        print(f"init weight from {args.torch_ckpt or ckpt}")
    evaluator = SlidingWindowEvaluator(
        model, cfg.patch_size, cfg.num_classes, cfg.stride_xy,
        cfg.stride_z, batch=cfg.eval_batch, device=device)
    return cfg, evaluator


def test_calculate_metric(args, dataset=None, device=None):
    """Evaluate the test split (or ``dataset``: anything with ``len`` and
    ``load(i) -> (image, label)``) and return the average metrics. With
    ``--save_result 1`` each case's NMS'd prediction, image and label go
    to ``<snapshot>/<model>_predictions/%02d_{pred,img,gt}.nii.gz``
    (float32, `utils/test_3d_patch.py:67-72`), written in the background
    while the next volume is evaluated, complete when this returns.
    With ``--num_devices N > 1`` it runs on N spawned ranks (the evaluator
    shards each volume over them); rank 0 prints, writes and returns."""
    return on_ranks(_test_rank, ranks(args), device or args.device,
                    args, dataset, device)


def _test_rank(args, dataset, device):
    cfg, evaluator = build_evaluator(args, device)
    ds = dataset if dataset is not None else LAHeartDataset(cfg.root_path,
                                                            "test")
    out_dir = snapshot_dir(cfg, f"{cfg.net_type}_predictions")
    if mesh.is_main():
        os.makedirs(out_dir, exist_ok=True)
    total = np.zeros(4)
    loaded = []

    def _images():
        for ith in range(len(ds)):
            loaded.append(ds.load(ith))
            yield loaded[-1][0]

    dumps = ResultWriter(args.save_result)
    try:
        # the device runs volume ith+1 while the host scores volume ith
        for ith, pred in enumerate(evaluator.infer_cases(
                _images(), rule=cfg.eval_rule)):
            image, label = loaded[ith]
            if not mesh.is_main():
                continue
            if args.nms:
                pred = host_largest_cc(pred)
            if pred.sum() == 0:
                m = (0.0, 0.0, 0.0, 0.0)
            else:
                m = calculate_metric_percase(pred, label)
            if args.detail:
                print("%02d,\t%.5f, %.5f, %.5f, %.5f" % (ith, *m))
            dumps.write([os.path.join(out_dir, "%02d_%s.nii.gz" % (ith, t))
                         for t in ("pred", "img", "gt")],
                        (pred, image, label))
            total += np.asarray(m)
    finally:
        dumps.close()
    if not mesh.is_main():
        return None
    avg = total / len(ds)
    print(f"average metric is {avg}")
    with open(os.path.join(out_dir, "..", "performance.txt"), "w") as f:
        f.write(f"average metric is {avg} \n")
    return avg


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(test_calculate_metric(args))


if __name__ == "__main__":
    main()
