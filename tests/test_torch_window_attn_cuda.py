"""The shifted-window attention kernels (``kernels/csrc/window_attn.cu``
through ``ops/window_attn.py``) on the card, against the op's plain
composition computed in f64 from the same bf16 inputs, at each SwinUNETR
stage's shape for a batch of 4 at 96^3 (a shifted and an unshifted block;
the fourth stage's 6^3 window, clipped, has no shift): O, dQ, dK, dV and
the table's gradient within stated tolerances, and no nearer the f64
composition for the plain bf16 composition than a small factor; two calls
bit for bit; the launch counters and the refusal of what the kernels do
not take; and one ``train_la`` self-train step of
the SwinUNETR at 96^3 with every attention call on the kernels. Every test
needs a CUDA device and skips without one; the file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_window_attn_cuda.py
"""

import pytest
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.ops import window_attn as wa

pytestmark = pytest.mark.cuda

#: stage -> (windows a sample, padded grid, window, heads)
STAGES = {
    "stage1": ((49,) * 3, (7,) * 3, 3),
    "stage2": ((28,) * 3, (7,) * 3, 6),
    "stage3": ((14,) * 3, (7,) * 3, 12),
    "stage4": ((6,) * 3, (6,) * 3, 24),
}
BATCH = 4
CASES = [(s, shifted) for s in STAGES for shifted in (False, True)
         if not (s == "stage4" and shifted)]
#: the kernels' largest relative error (norm of the difference over the
#: norm) against the f64 composition, and how far it may exceed the plain
#: bf16 composition's
TOL = {"out": 1e-2, "dqkv": 2e-2, "dtable": 2e-2}
FACTOR = 3.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    kernels.library("window_attn")
    return torch.device("cuda")


def _case(stage, shifted, dev, seed=0):
    padded, window, heads = STAGES[stage]
    shift = tuple(3 if shifted else 0 for _ in window)
    n = window[0] * window[1] * window[2]
    bw = BATCH * wa.window_count(padded, window)
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(bw, n, 3 * 16 * heads, generator=gen, device=dev)
           * 1.5).to(torch.bfloat16)
    table = torch.randn(wa.table_size(), heads, generator=gen,
                        device=dev) * 0.5
    g = (torch.randn(bw, n, 16 * heads, generator=gen, device=dev)
         * 1e-2).to(torch.bfloat16)
    return qkv, table, g, (padded, window, shift)


def _run(fn, qkv, table, g, geo):
    q = qkv.detach().clone().requires_grad_(True)
    t = table.detach().clone().requires_grad_(True)
    out = fn(q, t, *geo)
    out.backward(g.to(out.dtype))
    return out.detach(), q.grad, t.grad


def _err(x, ref):
    x, ref = x.double(), ref.double()
    return float((x - ref).norm() / ref.norm())


@pytest.mark.parametrize("stage,shifted", CASES)
def test_kernels_against_the_plain_composition(cuda_device, stage, shifted):
    qkv, table, g, geo = _case(stage, shifted, cuda_device)
    assert wa.kernel_refusal(qkv, table) is None
    got = _run(wa.window_attention, qkv, table, g, geo)
    exact = _run(wa.plain_window_attn, qkv.double(), table.double(),
                 g.double(), geo)
    plain = _run(wa.plain_window_attn, qkv, table, g, geo)
    for name, a, p, e in zip(("out", "dqkv", "dtable"), got, plain, exact):
        assert a.dtype == p.dtype and a.shape == p.shape, name
        err, base = _err(a, e), _err(p, e)
        print(f"{stage} shifted={shifted} {name}: kernels {err:.3e}, plain "
              f"bf16 {base:.3e}")
        assert err < TOL[name], (name, err)
        assert err < FACTOR * base + 1e-4, (name, err, base)


@pytest.mark.parametrize("stage", ["stage1", "stage4"])
def test_two_calls_agree_bit_for_bit(cuda_device, stage):
    qkv, table, g, geo = _case(stage, stage == "stage1", cuda_device, 3)
    a = _run(wa.window_attention, qkv, table, g, geo)
    b = _run(wa.window_attention, qkv, table, g, geo)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_launch_counters(cuda_device):
    qkv, table, g, geo = _case("stage3", True, cuda_device, 5)
    before = (wa.window_attn_fwd.launches, wa.window_attn_bwd.launches)
    _run(wa.window_attention, qkv, table, g, geo)
    with torch.no_grad():
        wa.window_attention(qkv, table, *geo)
        # a strided view is laid out densely and taken by the kernels
        wide = torch.cat([qkv, qkv], dim=-1)[..., :qkv.shape[-1]]
        assert torch.equal(wa.window_attention(wide, table, *geo),
                           wa.window_attention(qkv, table, *geo))
    assert wa.window_attn_fwd.launches - before[0] == 4
    assert wa.window_attn_bwd.launches - before[1] == 1
    # f32 on the card is refused, never given to the plain composition
    with pytest.raises(ValueError, match="bf16 qkv"):
        wa.window_attention(qkv.float(), table, *geo)
    assert wa.window_attn_fwd.launches - before[0] == 4


def test_trainer_refuses_what_the_kernels_do_not_take(cuda_device):
    """A SwinUNETR the kernels cannot run on the card (f32, or heads not
    16 wide) is refused before its first step."""
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.train.state import build_model
    from bcp_tpu_torch.train.trainer import check_trainable
    for over, words in (({"compute_dtype": "float32"}, "bf16"),
                        ({"n_filters": 24}, "heads of 16")):
        cfg = la_config(labelnum=4, patch_size=(96,) * 3,
                        net_type="swin_unetr").replace(**over)
        model = build_model(cfg, "test", cuda_device)
        with pytest.raises(ValueError, match=f"swin_unetr.*{words}"):
            check_trainable(cfg, model)
        del model


def test_train_la_step_takes_the_kernels(cuda_device):
    """One ``train_la`` self-train step (K = 1) of the SwinUNETR at 96^3,
    batch 4 (2 + 2): the teacher's forward and the student's forward
    each run the 8 blocks' attention on the kernels and the student's
    backward the 8 backwards (a call on the card takes the kernels or is
    refused)."""
    from test_torch_dispatch_cuda import _batches, _stacked
    from bcp_tpu_torch.config import la_config
    from bcp_tpu_torch.train.graphs import DispatchGroups
    from bcp_tpu_torch.train.state import init_state
    from bcp_tpu_torch.train.trainer import copy_paste_box, iteration_draws
    cfg = la_config(labelnum=4, patch_size=(96,) * 3, batch_size=4,
                    labeled_bs=2, compute_dtype="bfloat16",
                    net_type="swin_unetr")
    state = init_state(cfg, cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device)

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(cfg.seed, it, gen)), gen
    groups = DispatchGroups(state, cfg, "self", 1, draws)
    batch = _stacked(_batches(cfg, 1, "self", cuda_device))
    before = kernels.launch_counts()
    groups.run(batch, 1)
    torch.cuda.synchronize()
    groups.close()
    got = {k: v - before.get(k, 0) for k, v in kernels.launch_counts().items()}
    assert got["window_attn_fwd"] == 8 * 2
    assert got["window_attn_bwd"] == 8
