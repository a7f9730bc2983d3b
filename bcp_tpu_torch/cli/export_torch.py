"""Export a checkpoint of the port as a reference-loadable torch ``.pth``:
``bcp_tpu/cli/export_torch.py`` for the port.

The port's modules carry the reference names, so its own checkpoints
(``{net_type}_best_model.pth`` of a stage directory, or ``--ckpt``) are
reference state_dicts already, minus what the port deliberately does not
build: the dead contrastive heads of the reference modules
(`networks/unet.py:214-236`). ``--template fresh.pth``, a fresh
``state_dict()`` saved from the reference install, supplies those keys at
their initial values, so the export loads with ``strict=True``; without one
only the port's weights are written (load with ``strict=False``). As in the
JAX package (`torch_ckpt.py:239-300`), ``--variant pancreas`` requires a
template: the reference pancreas V-Net's head sits at ``branchs.0.1`` or,
built with dropout, ``branchs.0.2`` (`pancreas/Vnet.py:124-135`), which
only a real state_dict tells.

    python -m bcp_tpu_torch.cli.export_torch --variant la --labelnum 4 \\
        --template fresh.pth --out VNet_ref.pth

A JAX package (orbax) snapshot goes through ``bcp_tpu/cli/export_torch.py``
instead; the port reads the ``.pth`` that writes.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.convert import load_checkpoint
from bcp_tpu_torch.train.checkpoints import best_model_path, snapshot_dir

_CFGS = {"la": la_config, "acdc": acdc_config, "pancreas": pancreas_config}


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a bcp_tpu_torch checkpoint to a reference "
                    "torch .pth")
    p.add_argument("--variant", choices=sorted(_CFGS), default="la")
    p.add_argument("--labelnum", type=int, default=None)
    p.add_argument("--snapshot_root", type=str, default="./model/BCP")
    p.add_argument("--stage_name", type=str, default="self_train")
    p.add_argument("--ckpt", type=str, default=None,
                   help="explicit checkpoint .pth (overrides the "
                        "snapshot_root/stage_name naming)")
    p.add_argument("--template", type=str, default=None,
                   help="fresh reference state_dict() .pth supplying the "
                        "dead-head keys for strict loading (REQUIRED for "
                        "--variant pancreas)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--n_filters", type=int, default=None)
    return p


def export_state_dict(state_dict: Dict[str, torch.Tensor], net_type: str,
                      template: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` in the reference module's layout: the
    ``template``'s keys first, then the port's weights over them
    (`torch_ckpt.py:264-300`). A ``num_batches_tracked`` the template holds
    stays the template's (the JAX package writes one only where the
    template has none). A ``VNet_pancreas`` head moves to the template's
    ``branchs`` index."""
    if net_type == "VNet_pancreas" and not template:
        raise ValueError("export for VNet_pancreas requires a template "
                         "state_dict (its branchs head index depends on "
                         "the reference module's dropout flag)")
    template = dict(template or {})
    out = {k: v.clone() for k, v in template.items()}
    moved = net_type == "VNet_pancreas" and "branchs.0.2.weight" in template
    for k, v in state_dict.items():
        if moved and k.startswith("branchs.0.1."):
            k = "branchs.0.2." + k[len("branchs.0.1."):]
        if k.endswith("num_batches_tracked") and k in template:
            continue
        out[k] = v.detach().cpu().clone()
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    kw = {} if args.labelnum is None else {"labelnum": args.labelnum}
    cfg = _CFGS[args.variant](**kw).replace(
        snapshot_root=args.snapshot_root, n_filters=args.n_filters)
    ckpt = args.ckpt or best_model_path(
        snapshot_dir(cfg, args.stage_name), cfg.net_type)
    template = None
    if args.template:
        template = torch.load(args.template, map_location="cpu",
                              weights_only=True)
    sd = export_state_dict(load_checkpoint(ckpt, cfg.net_type), cfg.net_type,
                           template)
    torch.save(sd, args.out)
    print(f"exported {ckpt} ({cfg.net_type}) -> {args.out} "
          f"({len(sd)} tensors{', strict-loadable' if template else ''})")
    return sd


if __name__ == "__main__":
    main()
