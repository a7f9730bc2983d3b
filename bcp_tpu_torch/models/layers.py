"""Building blocks of the port's models: convs with a compute dtype, the
JAX package's grouped BatchNorm, the parameter-free instance norm,
element-wise and channel dropout, and the align-corners upsample.

Counterpart of ``bcp_tpu/models/layers.py``. Parameters stay f32 and keep
``nn.Conv2d`` / ``nn.Conv3d`` / ``nn.BatchNorm*d`` names and layouts, so a
reference state_dict loads by name; each forward casts input and
parameters to the module's compute dtype (bf16 for mixed precision), as
the flax modules' ``dtype`` does. The BatchNorm takes (N, C, *spatial) of
any rank.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bcp_tpu_torch.ops.conv3d import Conv3x3x3Function, kernel_takes
from bcp_tpu_torch.parallel import mesh


def _cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


class Conv3x3x3(nn.Conv3d):
    """3^3 stride-1 SAME conv: ``ZPackedConv3D`` (`layers.py:162-249`).

    Channel counts the CUDA kernels take go through
    ``Conv3x3x3Function``: kernel B forward and for dx, kernel C for dW on
    the card, their plain versions on the CPU; with ``fused_bwd`` (the JAX
    package's ``BCP_FUSED_BWD=1``, `layers.py:135-144`) a Ci == Co conv's
    dx and dW come from kernel D instead. The rest
    (the V-Net's Ci = 1 first conv) use ``F.conv3d``, as the JAX package
    leaves those to XLA. The bias is added after the conv, in the compute
    dtype (`layers.py:249`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None,
                 fused_bwd: bool = False):
        super().__init__(in_channels, out_channels, kernel_size=3,
                         padding=1)
        self.compute_dtype = dtype
        self.fused_bwd = fused_bwd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        w = self.weight.to(x.dtype)
        if kernel_takes(self.in_channels, self.out_channels):
            y = Conv3x3x3Function.apply(x, w, self.fused_bwd)
        else:
            y = F.conv3d(x, w, None, padding=1)
        return y + self.bias.to(x.dtype).view(1, -1, 1, 1, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computed in the compute dtype, bias included: the flax
    ``nn.Conv`` (`layers.py:40-44`) of every conv of the 2-D U-Net, which
    the JAX package leaves to XLA and the port to cuDNN."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computed in the compute dtype (the flax ``nn.Conv``
    with ``dtype``): the V-Net's stride-2 down-convs and 1^3 head."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype))


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computed in the compute dtype: the V-Net's
    stride-2 up-convs. The weight keeps torch's (Ci, Co, k, k, k) layout;
    ``convert.state_dict_from_flax`` undoes the flax kernel's spatial
    flip."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        return F.conv_transpose3d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class TorchBatchNorm(nn.Module):
    """``TorchBatchNorm`` (`layers.py:262-353`) with ``nn.BatchNorm3d``'s
    parameter and buffer names.

    Eval mode mirrors the running-average branch in the compute dtype
    (`layers.py:299-304`):
    ``x * (rsqrt(var + eps) * scale) + (bias - mean * inv * scale)``.

    Train mode (`layers.py:306-353`) treats the batch as ``groups``
    concatenated sub-batches, each normalised with its own statistics: the
    mean and E[x^2] in f32 (f64 stays f64) from the compute-dtype input,
    var = max(E[x^2] - mean^2, 0), and the normalisation's ``mul`` / ``add``
    cast to the compute dtype. The running statistics fold the groups one
    after another with momentum 0.9 (torch's 0.1) and the unbiased
    variance, unless ``update_running`` is off (the teacher's forward,
    :func:`frozen_running_stats`); ``num_batches_tracked`` counts one per
    group, as the reference's one forward per sub-batch does.

    In a world of several ranks (``parallel.mesh``) group g of the global
    batch is the union of every rank's group g: its mean and E[x^2] are
    the mean over the ranks of each rank's (``mesh.mean_statistics``,
    whose backward sums the gradient over the ranks), and the unbiased
    variance counts the global rows, as the JAX package's statistics over
    the sharded global batch do."""

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, groups: int = 1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.compute_dtype = dtype
        self.groups = groups
        self.update_running = True
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            mean = self.running_mean.to(dt)
            var = self.running_var.to(dt)
            scale = self.weight.to(dt)
            # eps rounded to dt first, as the JAX package's weakly typed
            # add; a 0-dim host tensor enters the kernel as a scalar, while
            # one made on the card would be a blocking copy that stalls the
            # host
            inv = torch.rsqrt(var + torch.tensor(self.eps, dtype=dt))
            mul = inv * scale
            add = self.bias.to(dt) - mean * inv * scale
            return x * mul.view(shape) + add.view(shape)
        G = self.groups
        n = x.shape[0]
        if n % G:
            raise ValueError(f"batch {n} does not split into {G} groups")
        xg = x.reshape(G, n // G, *x.shape[1:])
        red = (1,) + tuple(range(3, xg.dim()))
        sdt = torch.promote_types(torch.float32, dt)
        xf = xg.to(sdt)
        mean_g = xf.mean(dim=red)                       # (G, C)
        mean2_g = xf.square().mean(dim=red)
        if mesh.active():
            # group g of the global batch is every rank's group g
            mean_g, mean2_g = mesh.mean_statistics(
                torch.stack([mean_g, mean2_g])).unbind(0)
        var_g = torch.clamp(mean2_g - mean_g.square(), min=0.0)
        inv_g = torch.rsqrt(var_g + self.eps)
        scale = self.weight.to(sdt)[None]
        mul = (inv_g * scale).to(dt)
        add = (self.bias.to(sdt)[None] - mean_g * inv_g * scale).to(dt)
        shape_g = (G, 1, -1) + (1,) * (xg.dim() - 3)
        y = (xg * mul.view(shape_g) + add.view(shape_g)).reshape(x.shape)
        if self.update_running:
            count = xg[0, :, 0].numel() * mesh.world_size()
            with torch.no_grad():
                var_u = var_g * (count / max(count - 1, 1))
                m = self.momentum
                mean, var = self.running_mean, self.running_var
                for g in range(G):
                    mean = m * mean + (1 - m) * mean_g[g].to(mean.dtype)
                    var = m * var + (1 - m) * var_u[g].to(var.dtype)
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
                self.num_batches_tracked += G
        return y


class InstanceNorm(nn.Module):
    """Parameter-free instance norm, ``instance_norm`` (`layers.py:356-379`;
    torch's ``InstanceNorm3d`` defaults, `pancreas/Vnet.py:25`): the mean
    and biased variance over the spatial axes of each (sample, channel),
    ``(x - mean) * rsqrt(var + eps)``, no running statistics, the same in
    train and eval mode. The statistics are taken in f32 (f64 stays f64)
    over x's own layout, so channels_last_3d activations are not copied to
    NCDHW as ``F.instance_norm`` would; the normalisation is one
    ``addcmul`` pass in the compute dtype. It holds no state_dict entries,
    as the reference's ``InstanceNorm3d``."""

    def __init__(self, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cast(x, self.compute_dtype)
        sdt = torch.promote_types(torch.float32, x.dtype)
        var, mean = torch.var_mean(x.to(sdt), dim=tuple(range(2, x.dim())),
                                   unbiased=False, keepdim=True)
        rstd = torch.rsqrt(var + self.eps)
        return torch.addcmul((-mean * rstd).to(x.dtype), x, rstd.to(x.dtype))


def draw_uniform(shape: Sequence[int], generator: Optional[torch.Generator],
                 device, groups: int = 1) -> torch.Tensor:
    """``torch.rand(shape, generator=generator)`` of one forward's rows.
    In a world of several ranks the draw is made for the global batch
    (``groups`` concatenated sub-batches, every rank's rows of each) and
    this rank keeps its rows (``mesh.rank_rows``), so the masks are those
    a one-device run draws for the global batch."""
    shape = tuple(shape)
    if not mesh.active():
        return torch.rand(shape, generator=generator, device=device)
    u = torch.rand((shape[0] * mesh.world_size(), *shape[1:]),
                   generator=generator, device=device)
    return mesh.rank_rows(u, groups)


class Dropout(nn.Module):
    """Element-wise dropout, flax's ``nn.Dropout`` (`unet2d.py:39-40`): in
    train mode each element is kept with probability 1 - p, as
    ``where(keep, x / (1 - p), 0)``. The keep mask is ``keep`` when a
    caller set it (:func:`dropout_draws`), else drawn from ``generator``
    (a ``torch.Generator`` on x's device, or torch's default one when
    None; :func:`draw_uniform`, over the global batch of ``groups``
    sub-batches in a world of several ranks); its shape is
    :meth:`mask_shape`, x's own here."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.groups = 1
        self.keep: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor) -> torch.Size:
        return x.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = self.keep
        if keep is None:
            keep = draw_uniform(self.mask_shape(x), self.generator,
                                x.device, self.groups) < 1.0 - self.p
        keep = keep.to(x.device)
        keep = keep.reshape(*keep.shape, *(1,) * (x.dim() - keep.dim()))
        return torch.where(keep, x / (1.0 - self.p), 0.0)


class ChannelDropout(Dropout):
    """Channel dropout (`layers.py:411-420`; ``nn.Dropout3d`` semantics):
    each (sample, channel) map is kept or zeroed whole, so the keep mask
    is (N, C)."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)

    def mask_shape(self, x: torch.Tensor) -> torch.Size:
        return x.shape[:2]


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (N, C, H, W) on torch's ``align_corners=True``
    grid (`layers.py:425-438`, `networks/unet.py:50`), in x's dtype. The JAX
    package computes its scale in x's dtype too, so in bf16 the two sample
    slightly different positions; in f32 they agree."""
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]),
                         mode="bilinear", align_corners=True)


def _modules(model: nn.Module, kind) -> list:
    return [m for m in model.modules() if isinstance(m, kind)]


@contextlib.contextmanager
def bn_groups(model: nn.Module, groups: int) -> Iterator[None]:
    """Run ``model``'s BatchNorms with ``groups`` sub-batches
    (``VNet3D.bn_groups``, `vnet3d.py:170-172`; the self-train step's
    concat forwards use 2); its dropouts draw for the same layout."""
    bns = _modules(model, TorchBatchNorm) + _modules(model, Dropout)
    old = [m.groups for m in bns]
    for m in bns:
        m.groups = groups
    try:
        yield
    finally:
        for m, g in zip(bns, old):
            m.groups = g


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module) -> Iterator[None]:
    """Train-mode forwards that leave the running statistics as they are:
    the teacher's BN buffer updates are discarded (`steps.py:63-68`)."""
    bns = _modules(model, TorchBatchNorm)
    old = [m.update_running for m in bns]
    for m in bns:
        m.update_running = False
    try:
        yield
    finally:
        for m, flag in zip(bns, old):
            m.update_running = flag


@contextlib.contextmanager
def dropout_draws(model: nn.Module,
                  keep: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Iterator[None]:
    """Hand ``model``'s dropouts their draws for one forward: the keep
    masks ``keep`` (one bool tensor per dropout, in forward order, of the
    dropout's ``mask_shape``: (N, C) for a channel dropout, x's shape for
    an element-wise one), or a ``generator`` they draw from."""
    drops = _modules(model, Dropout)
    if keep is not None and len(keep) != len(drops):
        raise ValueError(f"{len(keep)} keep masks for {len(drops)} dropouts")
    for i, m in enumerate(drops):
        m.keep = None if keep is None else keep[i]
        m.generator = generator
    try:
        yield
    finally:
        for m in drops:
            m.keep = None
            m.generator = None


@contextlib.contextmanager
def record_dropout_shapes(model: nn.Module) -> Iterator[List[torch.Size]]:
    """Yield a list that fills, in call order, with the keep-mask shape of
    every train-mode dropout call of ``model`` inside the block: the shapes
    :func:`draw_keep_masks` draws for one forward."""
    shapes: List[torch.Size] = []

    def hook(module, args):
        if module.training:
            shapes.append(module.mask_shape(args[0]))
    handles = [m.register_forward_pre_hook(hook)
               for m in _modules(model, Dropout)]
    try:
        yield shapes
    finally:
        for h in handles:
            h.remove()


def draw_keep_masks(model: nn.Module, shapes: Sequence[Sequence[int]],
                    generator: Optional[torch.Generator], device=None,
                    out: Optional[Sequence[torch.Tensor]] = None,
                    groups: int = 1) -> List[torch.Tensor]:
    """The keep masks of one train-mode forward of ``model``, drawn ahead
    of it: for each dropout in module order (the order the port's models
    call them, which ``dropout_draws(keep=...)`` assumes too), the call its
    forward would make, ``torch.rand(shape, generator=generator) < 1 - p``,
    so the masks and the generator's state after them are the forward's
    own. ``shapes`` are the forward's mask shapes
    (:func:`record_dropout_shapes`); with ``out`` the masks are written
    into those bool tensors (a CUDA graph's static inputs). ``groups`` is
    the forward's number of sub-batches (:func:`bn_groups`), which lays
    out a world's global draw (:func:`draw_uniform`)."""
    drops = _modules(model, Dropout)
    if len(shapes) != len(drops):
        raise ValueError(f"{len(shapes)} mask shapes for {len(drops)} "
                         f"dropouts")
    if generator is not None:
        device = generator.device
    keep = []
    for i, (m, shape) in enumerate(zip(drops, shapes)):
        u = draw_uniform(shape, generator, device, groups)
        keep.append(u < 1.0 - m.p if out is None
                    else torch.lt(u, 1.0 - m.p, out=out[i]))
    return keep
