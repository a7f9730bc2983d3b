"""Zoo nets' train steps on the card: UNet3D (``ZOO``'s small widths,
where every 3^3 conv past the first has Ci and Co multiples of 16)
launches B, B-as-dx and C once a kernel-taking conv in a pre-train step
and B twice in a self-train step (and the fused bias + BatchNorm + ReLU
once a BatchNorm a forward and a backward), and its self-train step run
as a CUDA graph replay inside a K = 4 dispatch group ends in the state of
four eager steps with the same draws, bit for bit (cuDNN held to its
deterministic algorithms); and one of a full-width UNet3D's shapes on
halo'd slabs (``--sp_devices``) against the whole volume. Every test
needs a CUDA device and skips without one; the file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_zoo_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.models import create_model
from bcp_tpu_torch.models.layers import Conv3x3x3
from bcp_tpu_torch.ops.conv3d import kernel_takes
from bcp_tpu_torch.train.graphs import DispatchGroups
from bcp_tpu_torch.train.state import TrainState, build_optimizer
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import (copy_paste_box, copy_paste_mask,
                                         iteration_draws)
from test_torch_dispatch_cuda import _batches, _same, _stacked, _tensors

pytestmark = pytest.mark.cuda

FEAT = (16, 16, 32, 32, 32)
K = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written "
                    "kernels have no CPU mode")
    return torch.device("cuda")


def _cfg():
    return la_config(labelnum=4, patch_size=(16,) * 3, batch_size=4,
                     labeled_bs=2, compute_dtype="bfloat16",
                     net_type="unet_3D")


def _state(dev):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model("unet_3D", 2, mode="train",
                             compute_dtype=torch.bfloat16, device="cpu",
                             feat_channels=FEAT)
    model = model.to(dev)
    teacher = copy.deepcopy(model)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return TrainState(model, teacher, build_optimizer(_cfg(),
                                                      model.parameters()))


def _convs(model):
    return sum(isinstance(m, Conv3x3x3)
               and kernel_takes(m.in_channels, m.out_channels)
               for m in model.modules())


@pytest.mark.parametrize("stage", ["pre", "self"])
def test_zoo_step_launches_b_and_c_once_a_conv(cuda_device, stage):
    cfg = _cfg()
    state = _state(cuda_device)
    n = _convs(state.model)
    assert n == 17
    b = _batches(cfg, 1, stage, cuda_device)[0]
    gen = torch.Generator(device=cuda_device)
    mask = copy_paste_mask(cfg, iteration_draws(cfg.seed, 1, gen),
                           cuda_device)
    before = kernels.launch_counts()
    m = pretrain_step(state, b, mask, cfg, gen) if stage == "pre" else \
        selftrain_step(state, b, mask, cfg, gen, gen)
    torch.cuda.synchronize()
    got = {k: v - before.get(k, 0) for k, v in kernels.launch_counts().items()
           if v - before.get(k, 0)}
    # every (conv, BN, ReLU) on the fused op: one forward a network
    bns = 2 * 9 * (1 if stage == "pre" else 2)
    assert got == {"conv3x3x3_same": n * (1 if stage == "pre" else 2),
                   "conv3x3x3_dx": n, "conv3x3x3_dw": n,
                   "bn_relu_stats": bns, "bn_relu_apply": bns,
                   "bn_relu_grad": 2 * 9}
    assert all(np.isfinite(float(v)) for v in m.values())


def _eager(cfg, batches, dev, seed):
    state = _state(dev)
    gen = torch.Generator(device=dev)
    losses = []
    for it, b in enumerate(batches, start=1):
        mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen), dev)
        m = selftrain_step(state, b, mask, cfg, gen, gen)
        losses.append({k: float(v) for k, v in m.items()})
    return state, losses


def test_zoo_k4_graph_self_step_equals_k1(cuda_device):
    """Two groups of K = 4 (the first eager, the second two CUDA graphs a
    step, teacher and update, replayed four times) against eight eager
    steps with the same draws: two eager runs agree bit for bit, and so do
    the graph run's losses, student, teacher and momentum buffers."""
    torch.backends.cudnn.deterministic = True
    try:
        cfg = _cfg()
        seed = cfg.seed + 1
        batches = _batches(cfg, 2 * K, "self", cuda_device)
        want_state, want = _eager(cfg, batches, cuda_device, seed)
        again_state, again = _eager(cfg, batches, cuda_device, seed)
        state = _state(cuda_device)
        gen = torch.Generator(device=cuda_device)

        def draws(it):
            return copy_paste_box(cfg, iteration_draws(seed, it, gen)), gen
        groups = DispatchGroups(state, cfg, "self", K, draws)
        got = []
        for g in range(2):
            names, values = groups.run(_stacked(batches[K * g:K * g + K]),
                                       K * g + 1)
            got += [dict(zip(names, r)) for r in values.tolist()]
        torch.cuda.synchronize()
        counts = groups.close()
    finally:
        torch.backends.cudnn.deterministic = False
    assert counts == {"captures": 2, "replays": 2 * K}
    assert again == want and _same(_tensors(again_state),
                                   _tensors(want_state))
    assert got == want
    assert _same(_tensors(state), _tensors(want_state))


@pytest.mark.parametrize("S", [2, 4])
def test_zoo_halo_slabs_on_the_card(cuda_device, S):
    """One of a full-width UNet3D's halo'd shapes (level 1 of the LA
    patch: 256 -> 256 channels, 56 x 56 x 40, batch 2, bf16), slab by slab
    against the whole volume, as ``chip_smoke.py`` phase 18 (a) checks
    every shape: B's forward through ``Conv3x3x3Function``'s halo crop and
    B-as-dx folded back within 1e-2 of the whole's largest, C's dW summed
    over the slabs within 1e-3; and ``ConvTransposeSame3d`` (f32, cuDNN
    without TF32) on the padded slabs within 1e-4, forward and
    gradients."""
    import torch.nn.functional as F
    from bcp_tpu_torch.models.layers import ConvTransposeSame3d
    from bcp_tpu_torch.ops.conv3d import (Conv3x3x3Function, conv3x3x3_dw,
                                          conv3x3x3_dx, conv3x3x3_same)
    from bcp_tpu_torch.parallel import mesh
    kernels.build_all()
    g = torch.Generator(device=cuda_device).manual_seed(S)
    cl = torch.channels_last_3d

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            dtype).contiguous(memory_format=cl)

    def err(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    x, dy, w = rnd(2, 256, 56, 56, 40), rnd(2, 256, 56, 56, 40), \
        rnd(256, 256, 3, 3, 3).contiguous()
    with torch.no_grad():
        pads = mesh.halo_slabs(x, S)
        dys = [F.pad(d, (0, 0, 0, 0, 1, 1)).contiguous(memory_format=cl)
               for d in dy.chunk(S, 2)]
        fwd = torch.cat([Conv3x3x3Function.apply(p, w, False, True)
                         for p in pads], 2)
        assert err(fwd, conv3x3x3_same(x, w)) <= 1e-2
        dx = mesh.fold_slabs([conv3x3x3_dx(d, w) for d in dys])
        assert err(dx, conv3x3x3_dx(dy, w)) <= 1e-2
        dw = sum(conv3x3x3_dw(p, d) for p, d in zip(pads, dys))
        assert err(dw, conv3x3x3_dw(x, dy)) <= 1e-3

    conv = ConvTransposeSame3d(256, 64).to(cuda_device)
    xt = rnd(2, 256, 56, 56, 40, dtype=torch.float32)
    dyt = rnd(2, 64, 112, 112, 80, dtype=torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        whole = xt.clone().requires_grad_()
        y = conv(whole)
        y.backward(dyt)
        dw_whole = conv.weight.grad.clone()
        conv.zero_grad()
        part = xt.clone().requires_grad_()
        ys = torch.cat([conv.on_padded_slab(p)
                        for p in mesh.halo_slabs(part, S)], 2)
        ys.backward(dyt)
    assert err(ys, y) <= 1e-4
    assert err(part.grad, whole.grad) <= 1e-4
    assert err(conv.weight.grad, dw_whole) <= 1e-4
