"""LA two-stage BCP training CLI of the port: ``bcp_tpu/cli/train_la.py``
(flags of `LA_BCP_train.py:32-55`). Runs on the card by default.

    python -m bcp_tpu_torch.cli.train_la --root_path DATA/LA --labelnum 8

As in the JAX CLI the training volumes live on the device
(``--device_data_cache 1``) and validation runs in the background;
``--resume`` goes on from each stage's last saved state. ``--fused_bwd 1``
(the JAX package's ``BCP_FUSED_BWD=1``) computes every eligible 3^3 conv's
dx and dW in the one fused backward kernel. ``--steps_per_dispatch K``
makes K updates per host visit, as CUDA graph replays on the card
(``train.graphs``). ``--num_devices N`` trains data-parallel on N cards
(``parallel.mesh``; the CLI spawns one rank a card; ``--device cpu``: N
gloo processes): every rank holds the reference batch, the global batch is
N times it, and the training volumes stay on the host feed. With
``--sp_devices S`` the N ranks are N/S data indices by S space indices:
each volume's x extent is split over S ranks (halo exchanges around the
conv kernels), and the global batch is N/S times the reference's.
``--remat 1`` recomputes each V-Net block's activations in the backward.
"""

from __future__ import annotations

import argparse

from bcp_tpu_torch.cli.common import ranks, run_stages, train_on_ranks
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
                   help="data-parallel ranks, one card each (-1: every "
                        "visible card); the global batch scales with them")
    p.add_argument("--sp_devices", type=int, default=1,
                   help="split each volume's x extent over this many of "
                        "the ranks (must divide --num_devices and the "
                        "patch's x extent); the global batch scales by "
                        "num_devices // sp_devices")
    p.add_argument("--remat", type=int, default=0,
                   help="1: recompute each V-Net block's activations in "
                        "the backward (less memory, a second forward)")
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


def config_from_args(args, **overrides):
    """The LA config of the parsed flags; ``overrides`` set other fields
    (e.g. a small ``patch_size`` or ``n_filters`` for a test run). With
    several ranks the training volumes stay on the host feed, as in the
    JAX CLI (`train_la.py:73-74`)."""
    n = ranks(args)
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
        num_devices=n, sp_devices=args.sp_devices, remat=bool(args.remat),
        device_data_cache=bool(args.device_data_cache) and n == 1,
        steps_per_dispatch=args.steps_per_dispatch,
        fused_bwd=bool(args.fused_bwd)).replace(**overrides)


def build_trainer(args, train_dataset=None, val_cases=None, on_step=None,
                  **overrides) -> BCPTrainer:
    """The trainer of the parsed flags (one rank's); ``train_dataset`` /
    ``val_cases`` replace the h5 reads of ``--root_path`` and ``on_step``
    is the trainer's per-iteration hook (see ``BCPTrainer``)."""
    cfg = config_from_args(args, **overrides)
    return BCPTrainer(cfg, device=args.device, train_dataset=train_dataset,
                      val_cases=val_cases, on_step=on_step)


def train(args, train_dataset=None, val_cases=None, on_step=None,
          **overrides):
    """:func:`build_trainer`, then ``run_stages``. Returns (trainer,
    {stage: (best dice, best .pth path)}); with ``--num_devices N > 1`` on
    N ranks (``cli.common.train_on_ranks``), the trainer None."""
    return train_on_ranks("bcp_tpu_torch.cli.train_la", args, train_dataset,
                          val_cases, on_step, overrides)


def main(argv=None):
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
