"""The reference networks' shared pieces and their lookup by name.

Each reference architecture is one file, ``archs/<reference_net>.py``
beside this one, loaded by path (as the harness loads its drivers and
metric readers) when a configuration names it in ``reference_net``.
Nothing lists these files, so a new architecture is a new file alone. A
file provides, in plain PyTorch (importing neither the port nor JAX):

- ``build(widths, quantize=None) -> nn.Module``: the net at the
  configuration's ``widths``, whose parameter and buffer names are the
  ones the benchmark hands to both sides (so one state_dict loads into
  the net and into the port's model), and whose ``forward(x, keeps)``
  takes the keep masks of its dropouts (None: no dropout) and returns the
  logits. With ``quantize`` (a key of :data:`ROUNDING`) every value the
  program computes in its compute dtype is rounded, and the gradients
  flowing back through them (:class:`QConv`, :class:`QConvTranspose`,
  :func:`rounded`, :func:`round_outputs`): ``"fp8"`` to float8 e4m3,
  the gradients to e5m2 (one scale a tensor), around f32 arithmetic, the
  benchmark's control, the next precision below the bf16 the
  configurations state; ``"bf16"`` to bfloat16, a witness of what bf16
  alone does.
- ``dropout_shapes(widths, patch, n) -> [(shape, p), ...]``: each
  dropout's keep-mask shape and rate for one forward of ``n`` samples of
  ``patch``, in forward order (an element-wise mask's shape is its
  activation's, so it follows the patch). The masks are drawn by
  ``bcp.keep_masks``, ``rand(shape) < 1 - p``, the port's rule, and each
  dropout scales what it keeps by ``1 / (1 - p)``.
- optionally ``extra_flops(widths, patch, n) -> int``: the operations of
  one forward of ``n`` samples in matrix products that no conv or linear
  module call shows (attention's q k^T and p v); a backward counts
  twice them (both operands of each product take a gradient). Default 0.
- optionally ``seed_free(named, generator)``: fills, in place, the
  parameters that are neither a conv's, a linear layer's nor a norm's
  affine ((name, tensor) pairs in name order) from ``generator``;
  default N(0, 0.02^2) (``data.seeded_weights``).

Departures from the published modules, each for the comparison only: the
dropouts take their keep masks from the caller instead of drawing from
torch's global generator, so that both sides drop the same elements.
Everything computes in f32 with TF32 off (:func:`strict_f32`).
"""

from __future__ import annotations

import os
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.harness import load_module

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


def round_outputs(model: nn.Module, quantize: Optional[str],
                  kinds: Tuple[type, ...]) -> nn.Module:
    """``model`` with the outputs of its modules of ``kinds`` rounded as
    ``quantize`` says (nothing without it)."""
    if quantize is not None:
        for m in model.modules():
            if isinstance(m, kinds):
                m.register_forward_hook(
                    lambda mod, args, out: rounded(out, quantize))
    return model


# ------------------------------------------------ the architecture files
#: the directory of the architecture files
ARCHS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "archs")

_loaded: Dict[str, ModuleType] = {}


def arch(net: str) -> ModuleType:
    """The architecture file of ``net``, ``ARCHS/<net>.py``, loaded once."""
    path = os.path.join(ARCHS, f"{net}.py")
    if path not in _loaded:
        if not os.path.isfile(path):
            have = sorted(f[:-3] for f in os.listdir(ARCHS)
                          if f.endswith(".py"))
            raise ValueError(f"unknown reference net {net!r}: {ARCHS} "
                             f"holds {have}")
        _loaded[path] = load_module(path, f"bench_arch_{net}")
    return _loaded[path]


def build(net: str, widths: dict, quantize: Optional[str] = None
          ) -> nn.Module:
    """The reference net ``net`` at ``widths``, rounded as ``quantize``
    says."""
    return arch(net).build(widths, quantize)


def dropout_shapes(net: str, widths: dict, patch, n: int):
    """The (shape, p) of each dropout's keep mask for one forward of ``n``
    samples of ``patch``, in forward order."""
    return arch(net).dropout_shapes(widths, tuple(patch), n)


def extra_flops(net: str, widths: dict, patch, n: int) -> int:
    """The forward operations of ``n`` samples of ``patch`` in products no
    module call shows (0 where the file defines none)."""
    fn = getattr(arch(net), "extra_flops", None)
    return 0 if fn is None else int(fn(widths, tuple(patch), n))
