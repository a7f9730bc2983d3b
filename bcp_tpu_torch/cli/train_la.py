"""LA two-stage BCP training CLI of the port: ``bcp_tpu/cli/train_la.py``
(flags of `LA_BCP_train.py:32-55`). Runs on the card by default.

    python -m bcp_tpu_torch.cli.train_la --root_path DATA/LA --labelnum 8

As in the JAX CLI the training volumes live on the device
(``--device_data_cache 1``) and validation runs in the background;
``--resume`` goes on from each stage's last saved state. ``--fused_bwd 1``
(the JAX package's ``BCP_FUSED_BWD=1``) computes every eligible 3^3 conv's
dx and dW in the one fused backward kernel. ``--steps_per_dispatch K``
makes K updates per host visit, as CUDA graph replays on the card
(``train.graphs``).

Not ported yet, and refused with the ROADMAP item that brings them: more
than one device (``--num_devices``, ``--sp_devices``) and ``--remat 1``.
"""

from __future__ import annotations

import argparse

import torch

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.train.trainer import BCPTrainer


def build_parser():
    p = argparse.ArgumentParser(description="LA BCP training (CUDA)")
    p.add_argument("--root_path", type=str, default="./data/LA")
    p.add_argument("--exp", type=str, default="BCP")
    p.add_argument("--model", type=str, default="VNet")
    p.add_argument("--pre_max_iteration", type=int, default=2000)
    p.add_argument("--self_max_iteration", type=int, default=15000)
    p.add_argument("--max_samples", type=int, default=80)
    p.add_argument("--labeled_bs", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--labelnum", type=int, default=8)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--consistency", type=float, default=1.0)
    p.add_argument("--consistency_rampup", type=float, default=40.0)
    p.add_argument("--u_weight", type=float, default=0.5)
    p.add_argument("--mask_ratio", type=float, default=2 / 3)
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--stage", type=str, default="both",
                   choices=["both", "pre", "self"])
    p.add_argument("--resume", action="store_true",
                   help="resume each stage from its last saved state if "
                        "present")
    p.add_argument("--num_devices", type=int, default=1,
                   help="the port trains on one device (ROADMAP A4)")
    p.add_argument("--sp_devices", type=int, default=1,
                   help="the port trains on one device (ROADMAP A4)")
    p.add_argument("--remat", type=int, default=0,
                   help="not ported yet (ROADMAP A4: remat)")
    p.add_argument("--device_data_cache", type=int, default=1,
                   help="keep the training volumes on the device and crop/"
                        "augment there (~2-3 GB in bf16); 0 = host feed")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="K updates per host visit, run as CUDA graph "
                        "replays on the card (K eager steps on the CPU); "
                        "eval_every and each stage's iterations must be "
                        "multiples of K")
    p.add_argument("--fused_bwd", type=int, default=0, choices=[0, 1],
                   help="1: dx and dW of every Ci == Co 3^3 conv from the "
                        "one fused backward kernel; 0: the conv kernel on dy "
                        "plus the dW kernel")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _devices(n: int) -> int:
    """``-1`` means every visible card, as in the JAX CLI."""
    return max(torch.cuda.device_count(), 1) if n == -1 else n


def _refuse(args) -> None:
    refused = [
        (_devices(args.num_devices) != 1, "--num_devices != 1: the port "
         "trains on one device (ROADMAP A4, multi-GPU)"),
        (args.sp_devices != 1, "--sp_devices != 1: spatial partitioning is "
         "not ported (ROADMAP A4, multi-GPU)"),
        (bool(args.remat), "--remat 1 is not ported (ROADMAP A4, remat)"),
    ]
    for bad, why in refused:
        if bad:
            raise SystemExit(f"error: {why}")


def config_from_args(args, **overrides):
    """The LA config of the parsed flags; ``overrides`` set other fields
    (e.g. a small ``patch_size`` or ``n_filters`` for a test run)."""
    return la_config(labelnum=args.labelnum).replace(
        root_path=args.root_path, exp=args.exp, net_type=args.model,
        pre_iterations=args.pre_max_iteration,
        self_iterations=args.self_max_iteration,
        max_samples=args.max_samples, labeled_bs=args.labeled_bs,
        batch_size=args.batch_size, base_lr=args.base_lr, seed=args.seed,
        consistency=args.consistency,
        consistency_rampup=args.consistency_rampup,
        u_weight=args.u_weight, mask_ratio=args.mask_ratio,
        snapshot_root=args.snapshot_root, compute_dtype=args.compute_dtype,
        device_data_cache=bool(args.device_data_cache),
        steps_per_dispatch=args.steps_per_dispatch,
        fused_bwd=bool(args.fused_bwd)).replace(**overrides)


def build_trainer(args, train_dataset=None, val_cases=None, on_step=None,
                  **overrides) -> BCPTrainer:
    """The trainer of the parsed flags; ``train_dataset`` / ``val_cases``
    replace the h5 reads of ``--root_path`` and ``on_step`` is the
    trainer's per-iteration hook (see ``BCPTrainer``)."""
    _refuse(args)
    cfg = config_from_args(args, **overrides)
    return BCPTrainer(cfg, device=args.device, train_dataset=train_dataset,
                      val_cases=val_cases, on_step=on_step)


def run_stages(trainer: BCPTrainer, args):
    """Run the stages of ``--stage``: {stage: (best dice, best .pth)}."""
    print("Starting BCP training.")
    out = {}
    if args.stage in ("both", "pre"):
        out["pre"] = trainer.pretrain(resume=args.resume)
    if args.stage in ("both", "self"):
        out["self"] = trainer.selftrain(resume=args.resume)
    return out


def train(args, train_dataset=None, val_cases=None, on_step=None,
          **overrides):
    """:func:`build_trainer`, then :func:`run_stages`. Returns (trainer,
    {stage: (best dice, best .pth path)})."""
    trainer = build_trainer(args, train_dataset, val_cases, on_step,
                            **overrides)
    return trainer, run_stages(trainer, args)


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
