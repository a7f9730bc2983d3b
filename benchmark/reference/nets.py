"""The plain reference networks: the BCP V-Net (`networks/VNet.py:145-290`
of DeepMed-Lab-ECNU/BCP, batchnorm, n_filters 16) and the residual 3-D
U-Net (`networks/Unet3D.py:8-133`), in plain PyTorch.

Parameter and buffer names are the ones the benchmark hands to both sides
(the V-Net's are the reference repository's; the U-Net's follow the
module paths ``conv_blk1.conv1`` ... ``one_conv_0``), so one state_dict
loads into either.

Departures from the published modules, each for the comparison only:

- The channel dropouts (``nn.Dropout3d`` in the reference) take their
  keep masks from the caller, (N, C) bool, instead of drawing from
  torch's global generator, so that both sides drop the same channels.
- The projection heads the V-Net builds and never uses are left out.
- ``quantize="fp8"`` rounds every conv's input, weight and output and
  every BatchNorm and ReLU output to float8 e4m3, and the gradients
  flowing back through them to e5m2 (one scale a tensor), around f32
  arithmetic: the benchmark's control, the next precision below the bf16
  the configurations state. ``"bf16"`` rounds the same values to
  bfloat16: a witness of what bf16 alone does.
- The U-Net's transposed convs follow the SAME padding of the
  configuration's source (2n planes out of n: torch's unpadded transposed
  conv, cropped to its first 2n planes).

Everything computes in f32 with TF32 off (:func:`strict_f32`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def strict_f32() -> None:
    """No TF32 in matmuls and convs: the reference computes in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: a quantize mode -> (the forward's dtype and its largest value, the
#: backward's): "fp8" rounds values to e4m3 and gradients to e5m2, as fp8
#: training does; "bf16" rounds both to bfloat16
ROUNDING = {"fp8": ((torch.float8_e4m3fn, FP8_MAX),
                    (torch.float8_e5m2, 57344.0)),
            "bf16": ((torch.bfloat16, None), (torch.bfloat16, None))}


def round_to(x: torch.Tensor, dtype, top) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (with one scale, amax / ``top``, when the
    dtype's range needs one), back in x's dtype."""
    if top is None:
        return x.to(dtype).to(x.dtype)
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    """Rounds the value in the forward and the gradient in the backward."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return round_to(x, *ROUNDING[mode][0])

    @staticmethod
    def backward(ctx, g):
        return round_to(g, *ROUNDING[ctx.mode][1]), None


def rounded(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    return x if mode is None else _Round.apply(x, mode)


class QConv(nn.Conv3d):
    """``nn.Conv3d`` whose values and gradients may be rounded
    (:data:`ROUNDING`)."""

    def __init__(self, *args, quantize: Optional[str] = None, **kw):
        super().__init__(*args, **kw)
        self.quantize = quantize

    def forward(self, x):
        q = self.quantize
        return rounded(self._conv_forward(rounded(x, q), rounded(
            self.weight, q), self.bias), q)


class QConvTranspose(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose values and gradients may be rounded;
    ``crop`` keeps the first 2n planes of each axis (SAME padding)."""

    def __init__(self, *args, quantize: Optional[str] = None,
                 crop: bool = False, **kw):
        super().__init__(*args, **kw)
        self.quantize = quantize
        self.crop = crop

    def forward(self, x):
        q = self.quantize
        y = rounded(F.conv_transpose3d(
            rounded(x, q), rounded(self.weight, q), self.bias, self.stride,
            self.padding, self.output_padding, self.groups, self.dilation),
            q)
        if self.crop:
            X, Y, Z = x.shape[2:]
            y = y[:, :, :2 * X, :2 * Y, :2 * Z]
        return y


def drop_channels(x: torch.Tensor, keep: Optional[torch.Tensor],
                  p: float = 0.5) -> torch.Tensor:
    """``nn.Dropout3d`` with the caller's (N, C) keep mask; None: none."""
    if keep is None:
        return x
    return x * keep.to(x.dtype)[:, :, None, None, None] / (1.0 - p)


# ---------------------------------------------------------------- V-Net
def _stage(n: int, n_in: int, n_out: int, q) -> nn.Sequential:
    ops = []
    for i in range(n):
        ops += [QConv(n_in if i == 0 else n_out, n_out, 3, padding=1,
                      quantize=q), nn.BatchNorm3d(n_out), nn.ReLU()]
    return nn.Sequential(*ops)


class _Block(nn.Module):
    def __init__(self, seq: nn.Sequential):
        super().__init__()
        self.conv = seq

    def forward(self, x):
        return self.conv(x)


def _conv_block(n, n_in, n_out, q):
    return _Block(_stage(n, n_in, n_out, q))


def _down(n_in, n_out, q):
    return _Block(nn.Sequential(QConv(n_in, n_out, 2, stride=2, quantize=q),
                                nn.BatchNorm3d(n_out), nn.ReLU()))


def _up(n_in, n_out, q):
    return _Block(nn.Sequential(
        QConvTranspose(n_in, n_out, 2, stride=2, quantize=q),
        nn.BatchNorm3d(n_out), nn.ReLU()))


class VNetEncoder(nn.Module):
    def __init__(self, nf: int, q):
        super().__init__()
        self.block_one = _conv_block(1, 1, nf, q)
        self.block_one_dw = _down(nf, 2 * nf, q)
        self.block_two = _conv_block(2, 2 * nf, 2 * nf, q)
        self.block_two_dw = _down(2 * nf, 4 * nf, q)
        self.block_three = _conv_block(3, 4 * nf, 4 * nf, q)
        self.block_three_dw = _down(4 * nf, 8 * nf, q)
        self.block_four = _conv_block(3, 8 * nf, 8 * nf, q)
        self.block_four_dw = _down(8 * nf, 16 * nf, q)
        self.block_five = _conv_block(3, 16 * nf, 16 * nf, q)


class VNetDecoder(nn.Module):
    def __init__(self, nf: int, n_classes: int, q):
        super().__init__()
        self.block_five_up = _up(16 * nf, 8 * nf, q)
        self.block_six = _conv_block(3, 8 * nf, 8 * nf, q)
        self.block_six_up = _up(8 * nf, 4 * nf, q)
        self.block_seven = _conv_block(3, 4 * nf, 4 * nf, q)
        self.block_seven_up = _up(4 * nf, 2 * nf, q)
        self.block_eight = _conv_block(2, 2 * nf, 2 * nf, q)
        self.block_eight_up = _up(2 * nf, nf, q)
        self.block_nine = _conv_block(1, nf, nf, q)
        self.out_conv = QConv(nf, n_classes, 1, quantize=q)


class RefVNet(nn.Module):
    """The BCP V-Net. ``forward(x, keeps)``: ``keeps`` is None (no
    dropout) or the (N, 16 nf) and (N, nf) keep masks of the dropouts
    after block_five and block_nine. Returns the logits."""

    def __init__(self, n_filters: int = 16, n_classes: int = 2,
                 quantize: Optional[str] = None):
        super().__init__()
        self.encoder = VNetEncoder(n_filters, quantize)
        self.decoder = VNetDecoder(n_filters, n_classes, quantize)

    def forward(self, x, keeps: Optional[Sequence[torch.Tensor]] = None):
        e, d = self.encoder, self.decoder
        k5, k9 = keeps if keeps is not None else (None, None)
        x1 = e.block_one(x)
        x2 = e.block_two(e.block_one_dw(x1))
        x3 = e.block_three(e.block_two_dw(x2))
        x4 = e.block_four(e.block_three_dw(x3))
        x5 = drop_channels(e.block_five(e.block_four_dw(x4)), k5)
        x6 = d.block_six(d.block_five_up(x5) + x4)
        x7 = d.block_seven(d.block_six_up(x6) + x3)
        x8 = d.block_eight(d.block_seven_up(x7) + x2)
        x9 = drop_channels(d.block_nine(d.block_eight_up(x8) + x1), k9)
        return d.out_conv(x9)


# ---------------------------------------------------------------- UNet3D
class ResBlock(nn.Module):
    """`Conv3DBlock`: 2 x (3^3 conv, BN, ReLU) plus a bias-free 1^3 conv
    of the input."""

    def __init__(self, n_in: int, n_out: int, q):
        super().__init__()
        self.conv1 = QConv(n_in, n_out, 3, padding=1, quantize=q)
        self.bn1 = nn.BatchNorm3d(n_out)
        self.conv2 = QConv(n_out, n_out, 3, padding=1, quantize=q)
        self.bn2 = nn.BatchNorm3d(n_out)
        self.residual = QConv(n_in, n_out, 1, bias=False, quantize=q)

    def forward(self, x):
        q = self.conv1.quantize
        y = rounded(F.relu(self.bn1(self.conv1(x))), q)
        y = rounded(F.relu(self.bn2(self.conv2(y))), q)
        return y + self.residual(x)


class Deconv(nn.Module):
    def __init__(self, n_in: int, n_out: int, q):
        super().__init__()
        self.deconv = QConvTranspose(n_in, n_out, 3, stride=2, quantize=q,
                                     crop=True)

    def forward(self, x):
        return rounded(F.relu(self.deconv(x)), self.deconv.quantize)


class RefUNet3D(nn.Module):
    """The residual 3-D U-Net. ``forward(x, keeps)``: ``keeps`` is None or
    the keep masks of the dropouts after the level-3 and level-2 decoder
    blocks, in that order. Returns the logits."""

    def __init__(self, feat: Sequence[int] = (64, 256, 256, 512, 1024),
                 n_classes: int = 2, quantize: Optional[str] = None):
        super().__init__()
        fc = tuple(feat)
        ins = (1,) + fc[:4]
        for i in range(5):
            self.add_module(f"conv_blk{i + 1}", ResBlock(ins[i], fc[i],
                                                         quantize))
        for i in (4, 3, 2, 1):
            self.add_module(f"deconv_blk{i}", Deconv(fc[i], fc[i - 1],
                                                     quantize))
            self.add_module(f"dec_conv_blk{i}",
                            ResBlock(2 * fc[i - 1], fc[i - 1], quantize))
        self.one_conv_0 = QConv(fc[0], n_classes, 1, quantize=quantize)

    def forward(self, x, keeps: Optional[Sequence[torch.Tensor]] = None):
        drops = dict(zip((3, 2), keeps)) if keeps is not None else {}
        feats = [self.conv_blk1(x)]
        for i in range(2, 6):
            feats.append(getattr(self, f"conv_blk{i}")(
                F.max_pool3d(feats[-1], 2, 2)))
        d = feats[4]
        for i in (4, 3, 2, 1):
            up = getattr(self, f"deconv_blk{i}")(d)
            d = getattr(self, f"dec_conv_blk{i}")(
                torch.cat([up, feats[i - 1]], dim=1))
            if i in drops:
                d = drop_channels(d, drops[i])
        return self.one_conv_0(d)


def build(net: str, widths: dict, quantize: Optional[str] = None
          ) -> nn.Module:
    """The reference net ``net`` ("vnet" or "unet3d") at ``widths``. With
    ``quantize`` the BatchNorms' and ReLUs' outputs are rounded too, as
    the convs' are: every value the program computes in its compute
    dtype."""
    if net == "vnet":
        model = RefVNet(widths["n_filters"], widths["n_classes"], quantize)
    elif net == "unet3d":
        model = RefUNet3D(widths["feat_channels"], widths["n_classes"],
                          quantize)
    else:
        raise ValueError(f"unknown reference net {net!r}")
    if quantize is not None:
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm3d, nn.ReLU)):
                m.register_forward_hook(
                    lambda mod, args, out: rounded(out, quantize))
    return model


def dropout_shapes(net: str, widths: dict, n: int):
    """The (N, C) keep-mask shapes of one forward of ``n`` samples, in
    forward order."""
    if net == "vnet":
        nf = widths["n_filters"]
        return [(n, 16 * nf), (n, nf)]
    fc = widths["feat_channels"]
    return [(n, fc[2]), (n, fc[1])]
