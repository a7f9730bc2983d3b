"""The fused train-mode bias + BatchNorm + ReLU kernels
(``kernels/csrc/batch_norm_relu.cu`` through ``ops/bn_relu.py``) on the
card, against the op's plain version in bf16 at the UNet3D's level-0 and
level-4 shapes and a V-Net width: the forward bit for bit given the plain
version's statistics, the statistics, running averages and gradients
within stated tolerances; two calls bit for bit; a CUDA graph's capture
and replay; and over a UNet3D self-train K = 4 group, every train-mode
BatchNorm on the fused op (the plain-path count stays 0). Every test needs
a CUDA device and skips without one; the file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_bn_relu_cuda.py
"""

import pytest
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.models.layers import TorchBatchNorm, plain_train_batch_norm
from bcp_tpu_torch.ops import bn_relu as br

pytestmark = pytest.mark.cuda

EPS = 1e-5
MOMENTUM = 0.9

#: (N, C, X, Y, Z), groups: the UNet3D's level 0 and level 4 of an LA
#: patch at the self-train stage's batch, and the V-Net's level 0
SHAPES = {
    "unet3d_level0": ((4, 64, 112, 112, 80), 2),
    "unet3d_level4": ((4, 1024, 7, 7, 5), 2),
    "vnet_level0": ((4, 16, 112, 112, 80), 2),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    kernels.library("batch_norm_relu")
    return torch.device("cuda")


def _case(name, dev, seed=0):
    shape, G = SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]

    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, generator=gen, device=dev) * scale + shift

    # a conv output: per-channel offsets and scales
    y = (rnd(*shape) * rnd(1, C, 1, 1, 1).abs().add(0.5)
         + rnd(1, C, 1, 1, 1)).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    g = rnd(*shape, scale=1e-3).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    params = dict(cb=rnd(C, scale=0.3), w=rnd(C, scale=0.2, shift=1.0),
                  b=rnd(C, scale=0.2))
    return y, g, params, G


def _running(C, dev):
    return (torch.full((C,), 0.1, device=dev), torch.full((C,), 0.9,
                                                          device=dev),
            torch.zeros((), dtype=torch.long, device=dev))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_against_the_plain_version(cuda_device, name):
    """Apply bit for bit given the plain version's statistics (the same two
    bf16 roundings, then the ReLU). Statistics: the kernels' f32 sums run
    in another order than torch's mean, so mean, inv and d agree to 1e-4
    of the channel's scale (f32 sums of up to 2M bf16 values); mul and add
    to one bf16 step (2^-7 relative, the rounding of a value that moved in
    the last f32 bits); the running averages, f32 from those statistics,
    to 1e-4; num_batches_tracked exactly."""
    y, _, p, G = _case(name, cuda_device)
    cb = p["cb"].to(torch.bfloat16)
    want, st_ref = br.bn_relu_forward_reference(y, cb, p["w"], p["b"], G,
                                                EPS)
    out = br.bn_relu_apply(y, cb, st_ref, G)
    assert out.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(out, want)

    run = _running(y.shape[1], cuda_device)
    st = br.bn_relu_stats(y, cb, p["w"], p["b"], run, G, EPS, MOMENTUM)
    scale = st_ref[4].clamp(min=0).sqrt() + st_ref[0].abs()
    assert ((st[0] - st_ref[0]).abs() <= 1e-4 * scale).all()
    assert ((st[1] - st_ref[1]).abs() <= 1e-4 * st_ref[1]).all()
    assert ((st[4] - st_ref[4]).abs() <= 1e-4 * scale.square()).all()
    for i in (2, 3):
        assert ((st[i] - st_ref[i]).abs()
                <= 2 ** -7 * st_ref[i].abs() + 1e-6).all()
    ref = _running(y.shape[1], cuda_device)
    br.update_running_reference(*ref, st_ref, y[0, 0].numel() * 2,
                                MOMENTUM)
    for a, b in zip(run[:2], ref[:2]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    assert int(run[2]) == int(ref[2]) == G


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_backward_against_the_plain_version(cuda_device, name):
    """Given the kernels' statistics (so both take the same ReLU mask):
    dy within one bf16 step of the plain closed form (2^-7 relative, the
    one rounding of an f32 value whose S1, S2 were summed in another
    order), plus 1e-3 of dy's largest where the means' terms cancel; the
    BatchNorm weight's and bias' gradients to 1e-3 of their largest (f32
    sums of up to 2M products in another order); the conv bias' gradient,
    a sum of dy that cancels to rounding noise, to 1e-3 of sum |dy|."""
    y, g, p, G = _case(name, cuda_device)
    cb = p["cb"].to(torch.bfloat16)
    st = br.bn_relu_stats(y, cb, p["w"], p["b"], None, G, EPS, MOMENTUM)
    dy, dcb, dw, db = br.bn_relu_grad(g, y, cb, p["w"], st, G)
    want = br.bn_relu_backward_reference(g, y, cb, p["w"], st, G)
    assert dy.is_contiguous(memory_format=torch.channels_last_3d)
    a, b = dy.float(), want[0].float()
    assert ((a - b).abs() <= 2 ** -7 * b.abs()
            + 1e-3 * b.abs().max()).all()
    for got, ref in ((dw, want[2]), (db, want[3])):
        assert ((got - ref).abs() <= 1e-3 * ref.abs().max()).all()
    total = b.abs().sum(dim=(0, 2, 3, 4))
    assert ((dcb - want[1]).abs() <= 1e-3 * total).all()


def test_deterministic(cuda_device):
    """Two forwards and two backwards give the same bits."""
    y, g, p, G = _case("unet3d_level0", cuda_device, seed=1)
    w = p["w"].requires_grad_(True)
    outs = []
    for _ in range(2):
        y1 = y.clone().requires_grad_(True)
        cb = p["cb"].clone().requires_grad_(True)
        run = _running(y.shape[1], cuda_device)
        out = br.BnReLUFunction.apply(y1, cb, w, p["b"], run, G, EPS,
                                      MOMENTUM)
        out.backward(g)
        outs.append([out, y1.grad, cb.grad, w.grad.clone(), *run])
        w.grad = None
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_graph_capture_and_replay(cuda_device):
    """Forward and backward captured in a CUDA graph and replayed on new
    inputs give the eager results bit for bit, running averages too."""
    y, g, p, G = _case("unet3d_level4", cuda_device, seed=2)
    w = p["w"].requires_grad_(True)
    cb = p["cb"].requires_grad_(True)
    sy = y.clone().requires_grad_(True)
    sg = g.clone()
    run = _running(y.shape[1], cuda_device)

    def step():
        out = br.BnReLUFunction.apply(sy, cb, w, p["b"], run, G, EPS,
                                      MOMENTUM)
        dy, dcb, dw = torch.autograd.grad(out, (sy, cb, w), sg)
        return out, dy, dcb, dw

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()                       # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    y2, g2, _, _ = _case("unet3d_level4", cuda_device, seed=3)
    with torch.no_grad():
        sy.copy_(y2)
        sg.copy_(g2)
    start = [t.clone() for t in run]
    graph.replay()
    torch.cuda.synchronize()
    got = [t.clone() for t in static] + [t.clone() for t in run]
    for t, v in zip(run, start):
        t.copy_(v)
    want = list(step()) + list(run)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_unet3d_group_takes_the_fused_op(cuda_device):
    """Two K = 4 self-train groups of the zoo's UNet3D (eager, then
    captured and replayed): every train-mode BatchNorm is the fused op, so
    the plain-path count stays 0 while the fused wrappers launch."""
    from test_torch_dispatch_cuda import _batches, _stacked
    from test_torch_zoo_cuda import K, _cfg, _state
    from bcp_tpu_torch.train.graphs import DispatchGroups
    from bcp_tpu_torch.train.trainer import copy_paste_box, iteration_draws
    cfg = _cfg()
    state = _state(cuda_device)
    n_bn = sum(isinstance(m, TorchBatchNorm) for m in state.model.modules())
    gen = torch.Generator(device=cuda_device)

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(cfg.seed, it, gen)), gen
    groups = DispatchGroups(state, cfg, "self", K, draws)
    batches = _batches(cfg, 2 * K, "self", cuda_device)
    before = kernels.launch_counts()
    for grp in range(2):
        groups.run(_stacked(batches[K * grp:K * grp + K]), K * grp + 1)
    torch.cuda.synchronize()
    groups.close()
    got = {k: v - before.get(k, 0) for k, v in kernels.launch_counts().items()}
    assert got.get(plain_train_batch_norm.__name__, 0) == 0
    # teacher and student forwards, one backward, each step
    assert got["bn_relu_stats"] == got["bn_relu_apply"] == 2 * K * 2 * n_bn
    assert got["bn_relu_grad"] == 2 * K * n_bn


def test_another_layout_is_laid_out_first(cuda_device):
    """An NCDHW input (cuDNN's answer to the Ci = 1 first conv) gives the
    channels_last input's output and gradient bit for bit."""
    y, g, p, G = _case("unet3d_level4", cuda_device, seed=4)
    outs = []
    for t in (y, y.contiguous()):
        assert t.is_contiguous() != t.is_contiguous(
            memory_format=torch.channels_last_3d)
        t = t.detach().requires_grad_(True)
        out = br.BnReLUFunction.apply(t, p["cb"], p["w"], p["b"], None, G,
                                      EPS, MOMENTUM)
        out.backward(g)
        outs.append((out, t.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
