"""SwinUNETR in the port (``models/swin_unetr.py``, ``ops/window_attn.py``)
on the CPU against the benchmark's plain reference
(``benchmark/reference/archs/swin_unetr.py``) on seeded weights in f64:
the logits and every parameter's gradient, the tables included; the plain
window-attention op against a naive loop over windows and heads; the
shift mask against MONAI's ``compute_mask`` slices; the trainer's
refusals; and ``train_la``'s stages with ``--model swin_unetr`` at a tiny
patch.

The nets are compared at ``feature_size`` 24 (the published 48 costs four
times the convs' time in f64 on the CPU) with the published depths, heads
and window, at 64 x 32 x 32 and 32 x 32 x 64: between them a padded grid
with a shift (stage 1, grid 32 x 16 x 16 in 35 x 21 x 21), a window
clipped below 7^3 with the index's ``[:N, :N]`` and a shift on one axis
only (stage 3, 8 x 4 x 4 in windows of 7 x 4 x 4), and unshifted windows
(every first block; stage 4 has no shift at all). A 32^3 patch leaves the
bottleneck a single voxel, which torch's instance norm refuses in the
reference (as MONAI's does in training). The reference runs in eval mode,
the same arithmetic as train mode for a net with neither dropout nor
BatchNorm."""

from __future__ import annotations

import itertools
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import data  # noqa: E402
from benchmark.reference import nets  # noqa: E402
from bcp_tpu_torch.cli import test_la, train_la  # noqa: E402
from bcp_tpu_torch.config import la_config  # noqa: E402
from bcp_tpu_torch.data.datasets import VolumeList  # noqa: E402
from bcp_tpu_torch.data.synthetic import la_cases  # noqa: E402
from bcp_tpu_torch.models import swin_unetr as sw  # noqa: E402
from bcp_tpu_torch.models.factory import create_model  # noqa: E402
from bcp_tpu_torch.ops import window_attn as wa  # noqa: E402
from bcp_tpu_torch.train.trainer import check_trainable  # noqa: E402

WIDTHS = {"feature_size": 24, "depths": [2, 2, 2, 2],
          "num_heads": [3, 6, 12, 24], "window_size": 7, "patch_size": 2,
          "mlp_ratio": 4.0, "n_classes": 2}
SEED = 2**31 + 23
#: f64 on both sides: the port and the reference differ only in the order
#: of their sums (the attention's bias and scale, the instance norm's
#: variance), some 1e-13 of the largest value; 1e-9 leaves room for that
#: and fails on any difference of the mathematics
TOL = 1e-9


def _nets(shape):
    sd = {k: v.double() for k, v in data.seeded_weights(
        "swin_unetr", WIDTHS, SEED, "cpu").items()}
    ref = nets.build("swin_unetr", WIDTHS).double().eval()
    ref.load_state_dict(sd)
    port = create_model("swin_unetr", 2, "train", device="cpu",
                        n_filters=WIDTHS["feature_size"]).double()
    port.load_state_dict(sd)
    return ref, port


def test_the_sizes_cover_padding_shift_clipping_and_none():
    seen = set()
    for shape in ((64, 32, 32), (32, 32, 64)):
        for s in range(4):
            grid = [p // (2 * 2 ** s) for p in shape]
            for shifted in (False, True):
                win, shift, padded = sw.window_geometry(grid, 7, shifted)
                if any(shift) and tuple(padded) != tuple(grid):
                    seen.add("padded shifted")
                if math.prod(win) < 343 and any(shift):
                    seen.add("clipped shifted")
                if not any(shift):
                    seen.add("unshifted")
    assert seen == {"padded shifted", "clipped shifted", "unshifted"}


@pytest.mark.parametrize("shape", [(64, 32, 32), (32, 32, 64)])
def test_port_matches_the_reference_in_f64(shape):
    torch.manual_seed(0)
    ref, port = _nets(shape)
    x = torch.randn(1, 1, *shape, dtype=torch.float64)
    want = ref(x)
    got, _ = port(x)
    assert got.dtype == torch.float64 and got.shape == want.shape
    scale = float(want.detach().abs().max())
    assert float((got - want).abs().max()) <= TOL * scale
    g = torch.randn_like(want)
    (want * g).sum().backward()
    (got * g).sum().backward()
    grads = dict(ref.named_parameters())
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names) == sorted(grads)
    assert any("relative_position_bias_table" in n for n in names)
    for name, p in port.named_parameters():
        w = grads[name].grad
        assert p.grad is not None and w is not None, name
        err = float((p.grad - w).abs().max())
        assert err <= TOL * float(w.abs().max()) + 1e-300, (name, err)


def _naive(qkv, table, heads, padded, window, shift):
    """The attention window by window and head by head: each token's
    coordinates in its window (for the bias, in the 7^3 window its ordinal
    falls in) and its region from its coordinate on the shifted padded
    grid, every pair's bias and mask from those."""
    bw, n, c3 = qkv.shape
    hd = c3 // 3 // heads
    nw = wa.window_count(padded, window)
    per = [p // w for p, w in zip(padded, window)]
    out = torch.zeros(bw, n, heads * hd, dtype=qkv.dtype)
    seven = torch.tensor([(t // 49, t // 7 % 7, t % 7) for t in range(n)])
    d = seven[:, None, :] - seven[None, :, :] + 6
    index = (d[..., 0] * 13 + d[..., 1]) * 13 + d[..., 2]
    local = list(itertools.product(*[range(w) for w in window]))

    def region(coord):
        rid = 0
        for c, p, w, s in zip(coord, padded, window, shift):
            rid = rid * 3 + (0 if c < p - w else 1 if c < p - s else 2)
        return rid

    for b in range(bw):
        wi = b % nw
        origin = (wi // (per[1] * per[2]) * window[0],
                  wi // per[2] % per[1] * window[1], wi % per[2] * window[2])
        regions = torch.tensor([region([o + c for o, c in zip(origin, loc)])
                                for loc in local])
        apart = regions[:, None] != regions[None, :]
        for h in range(heads):
            q = qkv[b, :, h * hd:(h + 1) * hd] * hd ** -0.5
            k = qkv[b, :, (heads + h) * hd:(heads + h + 1) * hd]
            v = qkv[b, :, (2 * heads + h) * hd:(2 * heads + h + 1) * hd]
            a = q @ k.T + table[index, h]
            if any(shift):
                a = a - 100.0 * apart
            out[b, :, h * hd:(h + 1) * hd] = torch.softmax(a, dim=-1) @ v
    return out


@pytest.mark.parametrize("padded,window,shift", [
    ((14, 7, 4), (7, 7, 4), (3, 3, 0)),
    ((7, 7, 7), (7, 7, 7), (0, 0, 0)),
    ((4, 4, 2), (4, 4, 2), (0, 0, 0)),
])
def test_plain_op_equals_a_naive_loop(padded, window, shift):
    gen = torch.Generator().manual_seed(7)
    heads, hd = 2, 4
    n = math.prod(window)
    bw = 2 * wa.window_count(padded, window)
    qkv = torch.randn(bw, n, 3 * heads * hd, generator=gen,
                      dtype=torch.float64)
    table = torch.randn(wa.table_size(), heads, generator=gen,
                        dtype=torch.float64)
    g = torch.randn(bw, n, heads * hd, generator=gen, dtype=torch.float64)
    grads = []
    for fn in (lambda q, t: wa.window_attention(q, t, padded, window, shift),
               lambda q, t: _naive(q, t, heads, padded, window, shift)):
        q = qkv.clone().requires_grad_(True)
        t = table.clone().requires_grad_(True)
        out = fn(q, t)
        (out * g).sum().backward()
        grads.append((out.detach(), q.grad, t.grad))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)
    assert float(grads[0][2].abs().max()) > 0


def _monai_mask(dims, ws, ss):
    """MONAI's ``compute_mask``: regions cut by slices, ids differing."""
    img = np.zeros(dims, np.int64)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]),
                  slice(-ss[1], None)):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]),
                      slice(-ss[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    t = torch.from_numpy(img)[None, ..., None]
    win = sw.partition(t, ws)[..., 0]
    return win[:, None, :] != win[:, :, None]


@pytest.mark.parametrize("dims,ws,ss", [
    ((49, 49, 49), (7, 7, 7), (3, 3, 3)),
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((14, 4, 4), (7, 4, 4), (3, 0, 0)),
    ((21, 14, 7), (7, 7, 7), (3, 3, 0)),
])
def test_shift_mask_matches_monai_slices(dims, ws, ss):
    r = torch.from_numpy(wa.region_ids(dims, ws, ss))
    got = r[:, :, None] != r[:, None, :]
    assert torch.equal(got, _monai_mask(dims, ws, ss))
    assert got.any()


def test_relative_index_is_monais():
    coords = torch.stack(torch.meshgrid(*[torch.arange(7)] * 3,
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + 6
    want = rel[..., 0] * 169 + rel[..., 1] * 13 + rel[..., 2]
    assert np.array_equal(wa.relative_index(343), want.numpy())
    assert np.array_equal(wa.relative_index(216), want[:216, :216].numpy())


@pytest.mark.parametrize("overrides,words", [
    ({"patch_size": (112, 112, 80)}, "32 divides"),
    ({"patch_size": (96, 96, 96), "sp_devices": 2}, "no space split"),
])
def test_trainer_refuses(overrides, words):
    cfg = la_config(net_type="swin_unetr").replace(**overrides)
    with pytest.raises(ValueError, match=f"swin_unetr.*{words}"):
        check_trainable(cfg)
    check_trainable(cfg.replace(patch_size=(96, 96, 96), sp_devices=1))


def _qkv(windows=2, tokens=343, heads=3, width=16, dtype=torch.bfloat16):
    return (torch.zeros(windows, tokens, 3 * heads * width, dtype=dtype),
            torch.zeros(wa.table_size(), heads))


@pytest.mark.parametrize("case,words", [
    ("f32", "bf16 qkv"),
    ("heads of 8", "heads of 16"),
    ("400 tokens", "1 to 343 tokens"),
    ("strided", "dense"),
    ("table of 7^3", "the table is"),
])
def test_kernel_refusal_names_what_the_kernels_do_not_take(case, words):
    qkv, table = _qkv()
    assert wa.kernel_refusal(qkv, table) is None
    if case == "f32":
        qkv = qkv.float()
    elif case == "heads of 8":
        qkv, table = _qkv(width=8)
    elif case == "400 tokens":
        qkv, table = _qkv(tokens=400)
    elif case == "strided":
        qkv = _qkv(windows=4)[0][::2]
    else:
        table = table[:343]
    assert words in wa.kernel_refusal(qkv, table)


@pytest.mark.parametrize("fs,dtype,words", [
    (48, torch.bfloat16, None),
    (48, torch.float32, "bf16 compute dtype"),
    (24, torch.bfloat16, "heads of 16 channels, not [8]"),
])
def test_card_refusal(fs, dtype, words):
    """The net on the card must be one the window attention kernels take:
    bf16 and heads of 16 channels (the trainer refuses the rest up
    front)."""
    net = sw.SwinUNETR(feature_size=fs, depths=(1, 1, 1, 1), dtype=dtype)
    why = sw.card_refusal(net)
    assert why is None if words is None else words in why


def test_forward_refuses_an_extent_32_does_not_divide():
    port = create_model("swin_unetr", 2, "test", device="cpu", n_filters=12)
    with pytest.raises(ValueError, match="32 divides"):
        port(torch.zeros(1, 1, 32, 32, 48))


def test_train_la_trains_swin_unetr(tmp_path):
    """``train_la`` with ``--model swin_unetr --patch_size 32 32 32``: one
    pre-train and one self-train step at K = 1, at ``feature_size`` 12,
    each with a finite loss, and the self stage's best checkpoint written
    and loaded strictly into a fresh net; then ``test_la`` with the same
    flags evaluates a volume from that checkpoint."""
    args = train_la.build_parser().parse_args(
        ["--model", "swin_unetr", "--patch_size", "32", "32", "32",
         "--labelnum", "4", "--pre_max_iteration", "1",
         "--self_max_iteration", "1", "--snapshot_root", str(tmp_path),
         "--device", "cpu", "--steps_per_dispatch", "1"])
    logged = []
    trainer = train_la.build_trainer(
        args, train_dataset=VolumeList(la_cases(8, (36, 34, 33), seed=3)),
        val_cases=la_cases(1, (34, 33, 32), seed=4), n_filters=12,
        eval_every=1, compute_dtype="float32")
    trainer.on_metrics = lambda *a: logged.append(a)
    out = train_la.run_stages(trainer, args)
    assert trainer.cfg.patch_size == (32, 32, 32)
    stages = [a[0] for a in logged]
    assert "self" in stages
    assert all(np.isfinite(a[2]["loss"]) for a in logged)
    _, path = out["self"]
    fresh = create_model("swin_unetr", 2, "test", device="cpu",
                         n_filters=12)
    fresh.load_state_dict(torch.load(path, map_location="cpu"), strict=True)
    targs = test_la.build_parser().parse_args(
        ["--model", "swin_unetr", "--patch_size", "32", "32", "32",
         "--labelnum", "4", "--snapshot_root", str(tmp_path),
         "--n_filters", "12", "--device", "cpu", "--detail", "0",
         "--stride_xy", "16", "--stride_z", "16"])
    metrics = test_la.test_calculate_metric(
        targs, dataset=VolumeList(la_cases(1, (40, 36, 34), seed=5)))
    assert np.all(np.isfinite(np.asarray(metrics, dtype=float)))
