"""ACDC two-stage BCP training CLI of the port: ``bcp_tpu/cli/train_acdc.py``
(flags of `ACDC_BCP_train.py:33-56`). Runs on the card by default.

    python -m bcp_tpu_torch.cli.train_acdc --root_path DATA/ACDC --labelnum 7

The JAX CLI's defaults: the 2-D U-Net on 256x256 slices, batch 24 with
``labeled_bs`` 12, bf16, SGD at a constant rate, an EMA of the whole
state, the pre-train stage's optimizer carried into self-train, the train
slices on the device (``--device_data_cache 1``), validation in the
background; ``--resume`` goes on from each stage's last saved state;
``--steps_per_dispatch K`` makes K updates per host visit, as CUDA graph
replays on the card (``train.graphs``); ``--num_devices N`` trains
data-parallel on N cards (``cli.train_la`` says how), the slices on the
host feed.

Not ported yet, and refused with the ROADMAP item that brings it:
spatial partitioning (``--sp_devices``). The JAX CLI has no ``--remat``
(remat targets the V-Net pipelines).
"""

from __future__ import annotations

import argparse

from bcp_tpu_torch.cli.common import ranks, train_on_ranks
from bcp_tpu_torch.config import acdc_config
from bcp_tpu_torch.train.trainer import BCPTrainer


def build_parser():
    p = argparse.ArgumentParser(description="ACDC BCP training (CUDA)")
    p.add_argument("--root_path", type=str, default="./data/ACDC")
    p.add_argument("--exp", type=str, default="BCP")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--pre_iterations", type=int, default=10000)
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--labeled_bs", type=int, default=12)
    p.add_argument("--labelnum", type=int, default=7)
    p.add_argument("--u_weight", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--consistency", type=float, default=0.1)
    p.add_argument("--consistency_rampup", type=float, default=200.0)
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
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
    p.add_argument("--device_data_cache", type=int, default=1,
                   help="keep the train slices on the device and augment "
                        "there; 0 = host feed")
    p.add_argument("--device", type=str, default="cuda")
    return p


def config_from_args(args, **overrides):
    """The ACDC config of the parsed flags; ``overrides`` set other fields
    (e.g. a small ``patch_size`` or ``n_filters`` for a test run)."""
    n = ranks(args)
    return acdc_config(labelnum=args.labelnum).replace(
        root_path=args.root_path, exp=args.exp, net_type=args.model,
        pre_iterations=args.pre_iterations,
        self_iterations=args.max_iterations, batch_size=args.batch_size,
        labeled_bs=args.labeled_bs, base_lr=args.base_lr,
        num_classes=args.num_classes, seed=args.seed,
        u_weight=args.u_weight, consistency=args.consistency,
        consistency_rampup=args.consistency_rampup,
        snapshot_root=args.snapshot_root, compute_dtype=args.compute_dtype,
        num_devices=n,
        device_data_cache=bool(args.device_data_cache) and n == 1,
        steps_per_dispatch=args.steps_per_dispatch).replace(**overrides)


def build_trainer(args, train_dataset=None, val_cases=None, on_step=None,
                  **overrides) -> BCPTrainer:
    """The trainer of the parsed flags; ``train_dataset`` (e.g. a
    ``SliceList``) and ``val_cases`` ((image, label) volumes) replace the h5
    reads of ``--root_path`` and ``on_step`` is the trainer's per-iteration
    hook (see ``BCPTrainer``)."""
    cfg = config_from_args(args, **overrides)
    return BCPTrainer(cfg, device=args.device, train_dataset=train_dataset,
                      val_cases=val_cases, on_step=on_step)


def train(args, train_dataset=None, val_cases=None, on_step=None,
          **overrides):
    """:func:`build_trainer`, then the stages of ``--stage``. Returns
    (trainer, {stage: (best dice, best .pth path)}); with ``--num_devices
    N > 1`` on N ranks (``cli.common.train_on_ranks``), the trainer None."""
    return train_on_ranks("bcp_tpu_torch.cli.train_acdc", args,
                          train_dataset, val_cases, on_step, overrides)


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
