"""Train state: ``bcp_tpu/train/state.py`` for the port.

The student, its EMA teacher, the optimizer and the update counter. The
JAX package keeps them in one pytree that its jitted step returns anew;
here the modules and the optimizer are updated in place.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
from torch import nn

from bcp_tpu_torch.config import Config
from bcp_tpu_torch.device import resolve_device
from bcp_tpu_torch.models import create_model

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    model: nn.Module              # student, train mode
    teacher: nn.Module            # EMA teacher, train mode, no grads
    optimizer: torch.optim.Optimizer
    step: int = 0                 # updates done in this stage


def lr_at(cfg: Config, stage: str, step: int) -> float:
    """Pre-train, and self-train without ``lr_decay_every`` (ACDC): constant
    base_lr. LA self-train: base * 0.1**(step // lr_decay_every)
    (`state.py:34-44`, `LA_BCP_train.py:273-276`)."""
    if stage == "self" and cfg.lr_decay_every:
        return cfg.base_lr * 0.1 ** (step // cfg.lr_decay_every)
    return cfg.base_lr


def build_optimizer(cfg: Config,
                    params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """``build_optimizer`` (`state.py:47-65`). SGD:
    ``optim.SGD(lr, momentum=0.9, weight_decay=1e-4)``
    (`LA_BCP_train.py:135,218`), the decay added to the gradient before the
    momentum trace. Adam: pancreas' ``optim.Adam(lr=1e-3)``
    (`pancreas/dataloaders.py:182`), betas (0.9, 0.999), eps 1e-8, no
    decay, which is ``optax.adam``: optax's ``m_hat / (sqrt(v_hat) + eps)``
    and torch's ``(m / bc1) / (sqrt(v) / sqrt(bc2) + eps)`` are the same
    function. Its state (moments and step count) travels with the
    pre-train best to the self stage, as optax's ``count`` does. On the
    card Adam is ``capturable``: its step count stays on the device and
    its bias corrections are computed there, so a CUDA graph can capture
    the update (``train.graphs``); on the CPU it is not (the CPU is no
    capturable device)."""
    params = list(params)
    if cfg.optimizer == "adam":
        capturable = bool(params) and params[0].device.type == "cuda"
        return torch.optim.Adam(params, lr=cfg.base_lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay,
                                capturable=capturable)
    if cfg.optimizer != "sgd":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return torch.optim.SGD(params, lr=cfg.base_lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay)


def build_model(cfg: Config, mode: str = "train", device=None,
                seed: Optional[int] = None) -> nn.Module:
    """The config's model on ``device``, its initial weights drawn on the
    host from ``seed`` (torch's default initialisation, the reference's)
    without touching the global generator's state."""
    extra = {"n_filters": cfg.n_filters} if cfg.n_filters else {}
    if mode == "train" and cfg.fused_bwd:   # an eval model has no backward
        extra["fused_bwd"] = True
    if mode == "train" and cfg.remat:
        extra["remat"] = True
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = create_model(cfg.net_type, cfg.num_classes, mode=mode,
                             compute_dtype=_DTYPES[cfg.compute_dtype],
                             device="cpu", **extra)
    return model.to(resolve_device(device))


def init_state(cfg: Config, device=None,
               seed: Optional[int] = None) -> TrainState:
    """Student == teacher at the start (the reference loads both from the
    same weights, `LA_BCP_train.py:220-222`); fresh optimizer, step 0."""
    model = build_model(cfg, "train", device, seed)
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return TrainState(model, teacher, build_optimizer(cfg, model.parameters()))


def load_weights_only(state: TrainState, state_dict) -> TrainState:
    """`load_net` semantics (`checkpoints.py:102-114`): student weights and
    BN statistics from ``state_dict``, the teacher from the same weights;
    the optimizer and the step stay fresh."""
    state.model.load_state_dict(state_dict, strict=True)
    state.teacher.load_state_dict(state_dict, strict=True)
    return state


def load_with_opt(state: TrainState, state_dict, opt_state) -> TrainState:
    """`load_net_opt` semantics (`checkpoints.py:116-130`,
    `ACDC_BCP_train.py:335-336`, `train_pancreas.py:140-141`): student
    weights, BN statistics and the optimizer (SGD's momentum buffers, or
    Adam's moments and step count) from the checkpoint, the teacher from
    the same weights; the stage's step stays fresh."""
    load_weights_only(state, state_dict)
    load_optimizer(state.optimizer, opt_state)
    return state


def load_optimizer(opt: torch.optim.Optimizer, opt_state) -> None:
    """``opt.load_state_dict(opt_state)``, keeping ``opt``'s own
    ``capturable``: torch takes the saved groups' flag, and a state from
    an eager CPU run or a reference ``.pth`` says ``capturable: False``
    with Adam's ``step`` on the CPU, which a capturable Adam on the card
    cannot step (and the other way round). The flag is set back and each
    ``step`` moved beside its parameter (capturable) or to the CPU."""
    own = [g.get("capturable") for g in opt.param_groups]
    opt.load_state_dict(opt_state)
    for group, flag in zip(opt.param_groups, own):
        if flag is None:
            continue
        group["capturable"] = flag
        for p in group["params"]:
            st = opt.state.get(p, {})
            step = st.get("step")
            if isinstance(step, torch.Tensor):
                st["step"] = (step.to(p.device, torch.float32) if flag
                              else step.to("cpu"))
