"""``remat`` in the port (``models/vnet3d.py``): every V-Net block
rematerialised with a non-reentrant ``torch.utils.checkpoint``, on the CPU.

As ``tests/test_models.py::test_vnet_remat_bit_identical`` holds the JAX
package's ``nn.remat`` to the plain model, the port's remat model must
change no number: two LA self-train updates and a pre-train update (grouped
BatchNorm, channel dropout drawn by the trainer's generator) and two
pancreas self-train updates (instance norm, Adam) equal the plain model's
bit for bit: losses, student, teacher and optimizer state. The recomputed
forward moves no running statistic, so ``num_batches_tracked`` counts one
update a group. A remat model's state_dict is a plain one's; the U-Net
refuses remat with the JAX trainer's reason."""

import copy

import numpy as np
import pytest
import torch

from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.models.layers import bn_groups
from bcp_tpu_torch.models.vnet3d import (ConvBlock, DownBlock, UpBlock,
                                         set_remat)
from bcp_tpu_torch.ops.masks import boxes_mask
from bcp_tpu_torch.train.state import build_model, init_state
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import (BCPTrainer, copy_paste_box,
                                         iteration_draws)

import torch_port_helpers  # noqa: F401  (one torch thread a process)

S = (16, 16, 16)
CONFIGS = {
    "la": la_config(labelnum=4, n_filters=4, patch_size=S,
                    compute_dtype="float32"),
    "pancreas": pancreas_config(n_filters=4, patch_size=S, mask_patch=8,
                                compute_dtype="float32"),
}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {}
        for k in "ab":
            b[f"img_{k}"] = torch.from_numpy(
                rng.normal(size=(2, 1, *S)).astype(np.float32))
            b[f"uimg_{k}"] = torch.from_numpy(
                rng.normal(0.5, 1.0, size=(2, 1, *S)).astype(np.float32))
            b[f"lab_{k}"] = torch.from_numpy(
                rng.integers(0, 2, (2, *S)).astype(np.uint8))
        out.append(b)
    return out


def _train(cfg, stage, iterations=2):
    """``iterations`` updates from the seeded state: (losses, state)."""
    state = init_state(cfg, "cpu")
    gen = torch.Generator()
    seed = cfg.seed + (stage == "self")
    losses = []
    for it, b in enumerate(_batches(iterations), start=1):
        mask = boxes_mask(cfg.patch_size, copy_paste_box(
            cfg, iteration_draws(seed, it, gen)))
        if stage == "pre":
            m = pretrain_step(state, {k: v for k, v in b.items()
                                      if not k.startswith("u")}, mask, cfg,
                              gen)
        else:
            m = selftrain_step(state, b, mask, cfg, gen, gen)
        losses.append({k: v.item() for k, v in m.items()})
    return losses, state


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("variant,stage", [("la", "pre"), ("la", "self"),
                                           ("pancreas", "self")])
def test_remat_updates_are_the_plain_updates_bit_for_bit(variant, stage):
    cfg = CONFIGS[variant]
    want_losses, want = _train(cfg, stage)
    got_losses, got = _train(cfg.replace(remat=True), stage)
    blocks = [m for m in got.model.modules()
              if isinstance(m, (ConvBlock, DownBlock, UpBlock))]
    assert blocks and all(m.remat for m in blocks)
    assert not any(getattr(m, "remat", False)
                   for m in want.model.modules())
    assert got_losses == want_losses
    a, b = _tensors(got), _tensors(want)
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        assert torch.equal(a[k], v), k
    if variant == "la":
        # one running-stat update a BatchNorm group a step: 2 (pre) or 4
        tracked = {int(v) for k, v in a.items()
                   if k.startswith("model.")
                   and k.endswith("num_batches_tracked")}
        assert tracked == {2 if stage == "pre" else 4}


def test_remat_is_train_only_and_keeps_the_state_dict():
    cfg = CONFIGS["la"].replace(remat=True)
    train = build_model(cfg, "train", "cpu")
    plain = build_model(cfg.replace(remat=False), "train", "cpu")
    evaluate = build_model(cfg, "test", "cpu")
    assert list(train.state_dict()) == list(plain.state_dict())
    for k, v in plain.state_dict().items():
        assert torch.equal(train.state_dict()[k], v), k
    assert not any(getattr(m, "remat", False) for m in evaluate.modules())
    # an eval-mode or no-grad forward of a remat model runs plainly
    x = torch.randn(1, 1, *S)
    with torch.no_grad():
        a = train.eval()(x)[0]
        b = plain.eval()(x)[0]
    assert torch.equal(a, b)


def test_unet_refuses_remat():
    with pytest.raises(ValueError, match="remat targets the V-Net "
                                         "pipelines"):
        create_model("unet", 4, device="cpu", remat=True)
    cfg = acdc_config(labelnum=1, n_filters=4, patch_size=(32, 32),
                      remat=True)
    with pytest.raises(ValueError, match="remat targets the V-Net "
                                         "pipelines; net_type='unet'"):
        BCPTrainer(cfg, device="cpu", val_cases=[])


def test_recompute_keeps_the_groups_of_the_forward():
    """The backward of a 2-group forward recomputes each block with two
    groups, though the forward's ``bn_groups`` has exited: the gradients
    equal the plain model's."""
    torch.manual_seed(0)
    plain = create_model("VNet", 2, mode="train", device="cpu",
                         n_filters=4)
    remat = copy.deepcopy(plain)
    set_remat(remat, True)
    x = torch.randn(4, 1, *S)
    grads = []
    for net in (plain, remat):
        torch.manual_seed(1)   # the channel dropouts' draws
        with bn_groups(net, 2):
            out = net(x)[0]
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
