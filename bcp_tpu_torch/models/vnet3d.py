"""VNet3D, the 3-D segmentation net of the LA pipeline.

Counterpart of ``bcp_tpu/models/vnet3d.py`` with the reference module tree
(`networks/VNet.py:145-290`), so the state_dict names are the reference's:
``encoder.block_one.conv.0.weight`` ... ``decoder.out_conv.weight``, with
each block's Sequential stepping over [conv, norm, relu]. A reference LA
``.pth`` loads by name (``convert.load_reference_checkpoint``).

Tensors are logical NCDHW. On the card the activations run in
channels_last_3d, the layout of the conv kernel (each voxel's channels
contiguous, as the JAX package's NDHWC). The dead projection / prediction
heads of the reference are omitted as in the JAX package. With
``has_dropout`` (train-mode construction) a channel dropout follows
block_five and block_nine (`vnet3d.py:205-220`); it holds no parameters, so
train and eval models share one state_dict layout.

:class:`VNetPancreas` is the pancreas net (`pancreas/Vnet.py:92-194`,
``VNet3D(normalization="instancenorm")`` in the JAX package): the same
topology with a parameter-free instance norm and the reference's flat
names, ``block_one.conv.0.weight`` ... ``block_eight_up.conv.0.bias``,
block_nine and the head in its one-branch ``branchs`` list.

``remat`` (`vnet3d.py:173-193`, ``nn.remat`` of every stage, down and up
block) wraps each :class:`ConvBlock`, :class:`DownBlock` and
:class:`UpBlock` in a non-reentrant ``torch.utils.checkpoint`` in a
train-mode forward that records a backward: the block keeps its input and
recomputes its inner activations in the backward, so a larger patch or
batch fits one card, at the cost of a second forward of each block. The
recomputed forward runs with the BatchNorm groups of the first and updates
no running statistic (they move once a step), and no dropout lies inside
a block. The flag adds no module, so a remat model's state_dict is a plain
one's.

Under a space split (``parallel.mesh``) each level runs on x slabs or
replicated as :class:`~bcp_tpu_torch.models.layers.SpaceLevels` decides
from the input slab's extent and the four down steps: LA's 112 planes at
S = 2 give slabs of 56, 28, 14 and 7, so block_four_dw's input is
gathered, block_five and block_five_up run replicated, and block_six
takes its slab back; pancreas' 96 at S = 2 stays sliced to the bottom.
A remat block's recompute runs with the split as its forward had it, so
it re-issues the same halo exchanges in the same order on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bcp_tpu_torch.models.layers import (ChannelDropout, Conv3d, Conv3x3x3,
                                         ConvTranspose3d, InstanceNorm,
                                         SpaceLevels, TorchBatchNorm)
from bcp_tpu_torch.parallel import mesh

#: the V-Net's stride-2 down steps
DOWNS = 4


def _recompute_contexts(block: nn.Module):
    """``checkpoint``'s (forward, recompute) contexts for ``block``: the
    recompute runs with the BatchNorm groups and the space split of this
    forward (the step's ``bn_groups`` and the level's split have exited by
    the backward) and leaves the running statistics alone."""
    bns = [m for m in block.modules() if isinstance(m, TorchBatchNorm)]
    groups = [m.groups for m in bns]
    split = mesh.space_split()

    @contextlib.contextmanager
    def recompute():
        old = [(m.groups, m.update_running) for m in bns]
        for m, g in zip(bns, groups):
            m.groups, m.update_running = g, False
        try:
            with mesh.split(split):
                yield
        finally:
            for m, (g, flag) in zip(bns, old):
                m.groups, m.update_running = g, flag
    return contextlib.nullcontext(), recompute()


class _Remat(nn.Module):
    """A block whose train-mode forward with a backward to record is
    rematerialised when ``remat`` is set (module docstring)."""

    remat = False

    def forward(self, x):
        if self.remat and self.training and torch.is_grad_enabled():
            # no random op inside a block: no RNG state to stash (which a
            # CUDA graph capture could not read anyway)
            return checkpoint(self.conv, x, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=lambda: _recompute_contexts(self))
        return self.conv(x)


def _norm(kind: str, n: int, dtype) -> nn.Module:
    """The reference's ``normalization`` strings (`VNet.py:18-25`) the port
    has: ``"batchnorm"`` (LA) and ``"instancenorm"`` (pancreas). Either
    takes the Sequential slot after its conv, so indices step by 3."""
    if kind == "batchnorm":
        return TorchBatchNorm(n, dtype=dtype)
    if kind == "instancenorm":
        return InstanceNorm(dtype=dtype)
    raise ValueError(f"unknown normalization {kind!r}")


class ConvBlock(_Remat):
    """`ConvBlock` (`networks/VNet.py:6-32`): n x (3^3 conv, norm, relu)."""

    def __init__(self, n_stages: int, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None,
                 fused_bwd: bool = False, norm: str = "batchnorm"):
        super().__init__()
        ops = []
        for i in range(n_stages):
            ops += [Conv3x3x3(n_in if i == 0 else n_out, n_out, dtype=dtype,
                              fused_bwd=fused_bwd),
                    _norm(norm, n_out, dtype), nn.ReLU()]
        self.conv = nn.Sequential(*ops)


class DownBlock(_Remat):
    """`DownsamplingConvBlock` (`VNet.py:68-92`): 2^3 conv, stride 2."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None,
                 norm: str = "batchnorm"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv3d(n_in, n_out, 2, stride=2, dtype=dtype),
            _norm(norm, n_out, dtype), nn.ReLU())


class UpBlock(_Remat):
    """`UpsamplingDeconvBlock` (`VNet.py:95-119`): 2^3 deconv, stride 2."""

    def __init__(self, n_in: int, n_out: int,
                 dtype: Optional[torch.dtype] = None,
                 norm: str = "batchnorm"):
        super().__init__()
        self.conv = nn.Sequential(
            ConvTranspose3d(n_in, n_out, 2, stride=2, dtype=dtype),
            _norm(norm, n_out, dtype), nn.ReLU())


class Encoder(nn.Module):
    def __init__(self, n_channels: int, nf: int, dtype,
                 fused_bwd: bool = False):
        super().__init__()
        f = fused_bwd
        self.block_one = ConvBlock(1, n_channels, nf, dtype, f)
        self.block_one_dw = DownBlock(nf, 2 * nf, dtype)
        self.block_two = ConvBlock(2, 2 * nf, 2 * nf, dtype, f)
        self.block_two_dw = DownBlock(2 * nf, 4 * nf, dtype)
        self.block_three = ConvBlock(3, 4 * nf, 4 * nf, dtype, f)
        self.block_three_dw = DownBlock(4 * nf, 8 * nf, dtype)
        self.block_four = ConvBlock(3, 8 * nf, 8 * nf, dtype, f)
        self.block_four_dw = DownBlock(8 * nf, 16 * nf, dtype)
        self.block_five = ConvBlock(3, 16 * nf, 16 * nf, dtype, f)

    def forward(self, x, lv: SpaceLevels):
        return _encode(self, x, lv)


class Decoder(nn.Module):
    def __init__(self, n_classes: int, nf: int, dtype,
                 has_dropout: bool = False, fused_bwd: bool = False):
        super().__init__()
        f = fused_bwd
        self.block_five_up = UpBlock(16 * nf, 8 * nf, dtype)
        self.block_six = ConvBlock(3, 8 * nf, 8 * nf, dtype, f)
        self.block_six_up = UpBlock(8 * nf, 4 * nf, dtype)
        self.block_seven = ConvBlock(3, 4 * nf, 4 * nf, dtype, f)
        self.block_seven_up = UpBlock(4 * nf, 2 * nf, dtype)
        self.block_eight = ConvBlock(2, 2 * nf, 2 * nf, dtype, f)
        self.block_eight_up = UpBlock(2 * nf, nf, dtype)
        self.block_nine = ConvBlock(1, nf, nf, dtype, f)
        self.out_conv = Conv3d(nf, n_classes, 1, dtype=dtype)
        self.dropout = ChannelDropout() if has_dropout else nn.Identity()

    def forward(self, feats, lv: SpaceLevels):
        x8_up = _decode(self, feats, lv)
        x9 = self.dropout(lv.run(0, self.block_nine, x8_up))
        return self.out_conv(x9), x8_up


def _encode(m: nn.Module, x, lv: SpaceLevels):
    """The V-Net encoder's five levels on ``m``'s blocks."""
    x1 = lv.run(0, m.block_one, x)
    x2 = lv.run(1, m.block_two, lv.down(0, m.block_one_dw, x1))
    x3 = lv.run(2, m.block_three, lv.down(1, m.block_two_dw, x2))
    x4 = lv.run(3, m.block_four, lv.down(2, m.block_three_dw, x3))
    x5 = lv.run(4, m.block_five, lv.down(3, m.block_four_dw, x4))
    return x1, x2, x3, x4, x5


def _decode(m: nn.Module, feats, lv: SpaceLevels):
    """The V-Net decoder on ``m``'s blocks up to x8_up, block_nine's
    input."""
    x1, x2, x3, x4, x5 = feats
    x6 = lv.run(3, m.block_six, lv.up(3, m.block_five_up, x5) + x4)
    x7 = lv.run(2, m.block_seven, lv.up(2, m.block_six_up, x6) + x3)
    x8 = lv.run(1, m.block_eight, lv.up(1, m.block_seven_up, x7) + x2)
    return lv.up(0, m.block_eight_up, x8) + x1


def set_remat(model: nn.Module, on: bool) -> None:
    """Turn the rematerialisation of every block of ``model`` on or off."""
    for m in model.modules():
        if isinstance(m, _Remat):
            m.remat = bool(on)


class VNet3D(nn.Module):
    """`VNet` (`networks/VNet.py:145-290`) with batchnorm.

    ``forward(x)`` takes (B, n_channels, X, Y, Z) and returns
    ``(logits, x8_up)`` with the logits promoted to at least f32
    (`vnet3d.py:221-226`). ``dtype`` is the compute dtype; parameters stay
    f32. :func:`~bcp_tpu_torch.models.layers.bn_groups` sets the
    BatchNorms' number of sub-batches in train mode (`vnet3d.py:170-172`).
    ``fused_bwd`` hands every 3^3 conv's backward to the fused dx + dW
    kernel where it is eligible; the forward is the same. ``remat``
    rematerialises every block (module docstring)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 n_filters: int = 16, dtype: Optional[torch.dtype] = None,
                 has_dropout: bool = False, fused_bwd: bool = False,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = Encoder(n_channels, n_filters, dtype, fused_bwd)
        self.enc_dropout = ChannelDropout() if has_dropout else nn.Identity()
        self.decoder = Decoder(n_classes, n_filters, dtype, has_dropout,
                               fused_bwd)
        set_remat(self, remat)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        lv = SpaceLevels(x.shape[2], DOWNS)
        x1, x2, x3, x4, x5 = self.encoder(x, lv)
        logits, x8_up = self.decoder((x1, x2, x3, x4, self.enc_dropout(x5)),
                                     lv)
        return logits.to(torch.promote_types(torch.float32, logits.dtype)), \
            x8_up


class VNetPancreas(nn.Module):
    """The pancreas `VNet` (`pancreas/Vnet.py:92-194`): the V-Net topology
    with instance norm, no dropout (`factory.py:46-51`) and the reference's
    flat state_dict names. block_nine and the 1^3 head sit in the one
    branch of ``branchs`` (``branchs.0.0.conv.0``, ``branchs.0.1``); the
    reference's branch carries a ``Dropout3d`` at index 1 when built with
    dropout, and ``convert.load_reference_checkpoint`` moves such a file's
    head (``branchs.0.2``) to index 1. ``forward`` is
    :class:`VNet3D`'s: (logits promoted to at least f32, x8_up). Instance
    norm is per sample, so a concatenated batch gives exactly its parts'
    forwards and the BatchNorm group context has nothing to set."""

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 n_filters: int = 16, dtype: Optional[torch.dtype] = None,
                 fused_bwd: bool = False, remat: bool = False):
        super().__init__()
        nf, f, n = n_filters, fused_bwd, "instancenorm"
        self.compute_dtype = dtype
        self.block_one = ConvBlock(1, n_channels, nf, dtype, f, n)
        self.block_one_dw = DownBlock(nf, 2 * nf, dtype, n)
        self.block_two = ConvBlock(2, 2 * nf, 2 * nf, dtype, f, n)
        self.block_two_dw = DownBlock(2 * nf, 4 * nf, dtype, n)
        self.block_three = ConvBlock(3, 4 * nf, 4 * nf, dtype, f, n)
        self.block_three_dw = DownBlock(4 * nf, 8 * nf, dtype, n)
        self.block_four = ConvBlock(3, 8 * nf, 8 * nf, dtype, f, n)
        self.block_four_dw = DownBlock(8 * nf, 16 * nf, dtype, n)
        self.block_five = ConvBlock(3, 16 * nf, 16 * nf, dtype, f, n)
        self.block_five_up = UpBlock(16 * nf, 8 * nf, dtype, n)
        self.block_six = ConvBlock(3, 8 * nf, 8 * nf, dtype, f, n)
        self.block_six_up = UpBlock(8 * nf, 4 * nf, dtype, n)
        self.block_seven = ConvBlock(3, 4 * nf, 4 * nf, dtype, f, n)
        self.block_seven_up = UpBlock(4 * nf, 2 * nf, dtype, n)
        self.block_eight = ConvBlock(2, 2 * nf, 2 * nf, dtype, f, n)
        self.block_eight_up = UpBlock(2 * nf, nf, dtype, n)
        self.branchs = nn.ModuleList([nn.Sequential(
            ConvBlock(1, nf, nf, dtype, f, n),
            Conv3d(nf, n_classes, 1, dtype=dtype))])
        set_remat(self, remat)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        lv = SpaceLevels(x.shape[2], DOWNS)
        x8_up = _decode(self, _encode(self, x, lv), lv)
        logits = lv.run(0, self.branchs[0], x8_up)
        return logits.to(torch.promote_types(torch.float32, logits.dtype)), \
            x8_up
