"""Pancreas two-stage BCP training CLI of the port:
``bcp_tpu/cli/train_pancreas.py`` (the module globals of
`pancreas/train_pancreas.py:22-48` as flags). Runs on the card by default.

    python -m bcp_tpu_torch.cli.train_pancreas --data_root DATA/pancreas

The JAX CLI's defaults: the instance-norm V-Net on 96^3 patches, four
streams of ``--batch_size`` 2 (a 2 + 2 labelled pair and a 2 + 2
unlabelled pair, batch 8), Adam at lr 1e-3, bf16, the fixed 64^3 copy-paste
cube, the pre-train stage's optimizer carried into self-train, the train
volumes on the device (``--device_data_cache 1``), validation in the
background. Epochs become iterations through the feed's epoch length
(``--pretraining_epochs`` x 30 and ``--self_training_epochs`` x 25 on the
reference's lists at 20 %); ``--resume`` goes on from each stage's last
saved state; ``--steps_per_dispatch K`` makes K updates per host visit, as
CUDA graph replays on the card (``train.graphs``); ``--num_devices N``
trains data-parallel on N cards (``cli.train_la`` says how), the volumes on
the host feed and the epochs N times shorter; ``--remat 1`` recomputes each
V-Net block's activations in the backward.

Not ported yet, and refused with the ROADMAP item that brings it:
spatial partitioning (``--sp_devices``).
"""

from __future__ import annotations

import argparse

from bcp_tpu_torch.cli.common import ranks, train_on_ranks
from bcp_tpu_torch.config import pancreas_config
from bcp_tpu_torch.data.datasets import PancreasDataset
from bcp_tpu_torch.data.feed import pancreas_steps_per_epoch
from bcp_tpu_torch.train.trainer import BCPTrainer


def build_parser():
    p = argparse.ArgumentParser(description="Pancreas BCP training (CUDA)")
    p.add_argument("--data_root", type=str, default="./data/pancreas")
    p.add_argument("--label_percent", type=int, default=20,
                   choices=[10, 20])
    p.add_argument("--batch_size", type=int, default=2,
                   help="per-stream batch (reference batch_size=2)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pretraining_epochs", type=int, default=60)
    p.add_argument("--self_training_epochs", type=int, default=200)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--snapshot_root", type=str, default="./result/cutmix")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--stage", type=str, default="both",
                   choices=["both", "pre", "self"])
    p.add_argument("--resume", action="store_true",
                   help="resume each stage from its last saved state if "
                        "present")
    p.add_argument("--num_devices", type=int, default=1,
                   help="data-parallel ranks, one card each (-1: every "
                        "visible card); the global batch scales with them")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="K updates per host visit, run as CUDA graph "
                        "replays on the card (K eager steps on the CPU); "
                        "eval_every and each stage's iterations must be "
                        "multiples of K")
    p.add_argument("--sp_devices", type=int, default=1,
                   help="spatial partitioning: not ported (ROADMAP A4)")
    p.add_argument("--remat", type=int, default=0,
                   help="1: recompute each V-Net block's activations in "
                        "the backward (less memory, a second forward)")
    p.add_argument("--device_data_cache", type=int, default=1,
                   help="keep the train volumes on the device and crop "
                        "there; 0 = host feed")
    p.add_argument("--device", type=str, default="cuda")
    return p


def config_from_args(args, train_dataset=None, **overrides):
    """The pancreas config of the parsed flags, its iterations the epochs
    times the feed's epoch length on ``train_dataset`` (the (labelled,
    unlabelled) lists under ``--data_root`` when None); ``overrides`` set
    other fields last (e.g. a small ``patch_size`` or ``n_filters`` for a
    test run). With N ranks an epoch is the feed's epoch of N-times-wider
    streams."""
    n = ranks(args)
    cfg = pancreas_config(label_percent=args.label_percent).replace(
        root_path=args.data_root, base_lr=args.lr, seed=args.seed,
        batch_size=4 * args.batch_size, labeled_bs=2 * args.batch_size,
        snapshot_root=args.snapshot_root, compute_dtype=args.compute_dtype,
        num_devices=n, remat=bool(args.remat),
        device_data_cache=bool(args.device_data_cache) and n == 1,
        steps_per_dispatch=args.steps_per_dispatch)
    lists = train_dataset or tuple(
        PancreasDataset(cfg.root_path, split, cache=False)
        for split in ("train_lab", "train_unlab"))
    return cfg.replace(
        pre_iterations=args.pretraining_epochs * pancreas_steps_per_epoch(
            cfg, "pre", lists, n),
        self_iterations=args.self_training_epochs
        * pancreas_steps_per_epoch(cfg, "self", lists, n)).replace(
            **overrides)


def build_trainer(args, train_dataset=None, val_cases=None, on_step=None,
                  **overrides) -> BCPTrainer:
    """The trainer of the parsed flags; ``train_dataset`` (a (labelled,
    unlabelled) pair of ``PancreasList``) and ``val_cases`` ((image,
    label) test volumes, centre-cropped by the trainer) replace the h5
    reads of ``--data_root`` and ``on_step`` is the trainer's
    per-iteration hook (see ``BCPTrainer``)."""
    cfg = config_from_args(args, train_dataset, **overrides)
    return BCPTrainer(cfg, device=args.device, train_dataset=train_dataset,
                      val_cases=val_cases, on_step=on_step)


def train(args, train_dataset=None, val_cases=None, on_step=None,
          **overrides):
    """:func:`build_trainer`, then the stages of ``--stage``. Returns
    (trainer, {stage: (best dice, best .pth path)}); with ``--num_devices
    N > 1`` on N ranks (``cli.common.train_on_ranks``), the trainer None."""
    return train_on_ranks("bcp_tpu_torch.cli.train_pancreas", args,
                          train_dataset, val_cases, on_step, overrides)


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
