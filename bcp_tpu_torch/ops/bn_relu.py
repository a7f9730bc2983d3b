"""Train-mode bias + grouped BatchNorm + ReLU of a 3^3 conv's output as one
op with its own backward: ``relu(TorchBatchNorm(y + conv_bias))``.

Replaces no Pallas kernel (the JAX package leaves the chain to XLA). On the
card, eager PyTorch runs the chain of ``models/layers.py`` (the conv's bias
add, :class:`~bcp_tpu_torch.models.layers.TorchBatchNorm`'s train branch,
``F.relu``) and autograd's backward of it as some twenty strided
elementwise and reduction passes, and saves an f32 copy of the input for
the backward. The hand-written kernels (``kernels/csrc/batch_norm_relu.cu``)
read the conv's bf16 output twice and write the result once forward, read
the gradient and that output twice and write the input gradient once
backward, and save only the conv's output and the (G, C) statistics.

:func:`fused_route` decides from the call's tensors which calls take the
op: a 4-D or 5-D bf16 tensor on the card with C % 8 == 0, outside a world
of several ranks (whose statistics need an all-reduce between the
statistics and the apply; a world of one rank's is the identity), with
the BatchNorm's parameters and running averages f32 beside it. Everything else keeps the plain chain. The
kernels read dense channels_last: the op copies a tensor in another layout
first, which on the nets' paths is only cuDNN's NCDHW answer to the
V-Net's and the UNet3D's Ci = 1 first conv.

:class:`BnReLUFunction` runs the kernels on a CUDA tensor and the plain
version (:func:`bn_relu_forward_reference`, :func:`update_running_reference`,
:func:`bn_relu_backward_reference`: explicit statistics and apply, the
closed-form backward) on a CPU tensor; in f64 the plain version is the
autograd of the chain to rounding. Rounding, as the chain's: the bias add,
``z * mul`` and ``+ add`` each round to bf16; the statistics are f32 sums of
the bf16 input; ``mul`` and ``add`` are rounded to bf16; the backward's sums
and coefficients are f32 and the input gradient is rounded once to bf16.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.ops.conv3d import _sm_count
from bcp_tpu_torch.parallel import mesh

#: the kernels' block (threads), channels a thread loads at once, rows a
#: thread has in flight, and the widest channel tile of a block
THREADS = 256
VEC = 8
UNROLL = 4
MAX_CTILE = 256
#: blocks a launch aims for on each SM
BLOCKS_PER_SM = 8

_LAYOUTS = {4: torch.channels_last, 5: torch.channels_last_3d}


def fused_route(y: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                params: Sequence[torch.Tensor] = ()) -> bool:
    """Whether a train-mode call on ``y`` (N, C, ...) of a BatchNorm
    computing in ``compute_dtype`` takes the fused op: 4-D or 5-D, bf16 on
    the card, C % 8 == 0, no world of several ranks (``parallel.mesh``: a
    world of one rank takes it, its all-reduce being the identity),
    and each of ``params`` (the BatchNorm's weight, bias and running
    averages, which the kernels read as dense f32) f32, dense, of C and on
    y's device. The layout is the op's business: it copies a tensor that
    is not dense channels_last."""
    C = y.shape[1] if y.dim() > 1 else 0
    return (y.is_cuda and y.dim() in _LAYOUTS and y.dtype == torch.bfloat16
            and compute_dtype in (None, torch.bfloat16)
            and C % VEC == 0 and y.numel() > 0 and mesh.world_size() == 1
            and all(p.dtype == torch.float32 and p.shape == (C,)
                    and p.is_contiguous() and p.device == y.device
                    for p in params))


@functools.lru_cache(maxsize=None)
def bn_geometry(rows_g: int, C: int, G: int, sms: int) -> Tuple[int, int]:
    """(chunks, ctile) of a launch over G groups of ``rows_g`` rows of C
    channels: a block takes the widest channel tile (a multiple of 8
    dividing C, at most 256) and one of ``chunks`` row ranges of a group;
    the chunks aim at ``BLOCKS_PER_SM`` blocks an SM, each with at least
    one unrolled step of rows a thread."""
    ctile = max(t for t in range(VEC, min(C, MAX_CTILE) + 1, VEC)
                if C % t == 0)
    rb = THREADS // (ctile // VEC)
    want = -(-BLOCKS_PER_SM * sms // (G * (C // ctile)))
    most = -(-rows_g // (rb * UNROLL))
    return max(1, min(want, most)), ctile


def _stat_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(torch.float32, dt)


def _grouped(t: torch.Tensor, G: int) -> torch.Tensor:
    n = t.shape[0]
    if n % G:
        raise ValueError(f"batch {n} does not split into {G} groups")
    return t.reshape(G, n // G, *t.shape[1:])


def _per_group(v: torch.Tensor, zg: torch.Tensor) -> torch.Tensor:
    """(G, C) as (G, 1, C, 1, ...) against a grouped tensor."""
    return v.view(v.shape[0], 1, -1, *(1,) * (zg.dim() - 3))


def bn_relu_forward_reference(y: torch.Tensor, cb: torch.Tensor,
                              weight: torch.Tensor, bias: torch.Tensor,
                              groups: int, eps: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``relu(TorchBatchNorm(y + cb))`` in train mode,
    ``cb`` already in y's dtype. Returns the output and the (5, G, C)
    statistics (mean, inv, mul, add, d = E[z^2] - mean^2) in f32 (f64 for
    f64), the table the backward reads."""
    dt = y.dtype
    z = y + cb.view(1, -1, *(1,) * (y.dim() - 2))
    zg = _grouped(z, groups)
    red = (1,) + tuple(range(3, zg.dim()))
    zf = zg.to(_stat_dtype(dt))
    mean = zf.mean(dim=red)
    d = zf.square().mean(dim=red) - mean.square()
    inv = torch.rsqrt(torch.clamp(d, min=0.0) + eps)
    scale = weight.to(zf.dtype)[None]
    mul = (inv * scale).to(dt)
    add = (bias.to(zf.dtype)[None] - mean * inv * scale).to(dt)
    out = torch.relu(zg * _per_group(mul, zg) + _per_group(add, zg))
    st = torch.stack([mean, inv, mul.to(zf.dtype), add.to(zf.dtype), d])
    return out.reshape(y.shape), st


def update_running_reference(running_mean: torch.Tensor,
                             running_var: torch.Tensor,
                             num_batches_tracked: torch.Tensor,
                             st: torch.Tensor, count: int,
                             momentum: float) -> None:
    """The running averages after a forward whose statistics are ``st``
    over ``count`` rows a group: the groups folded in order with
    ``momentum`` and the unbiased variance, one ``num_batches_tracked`` a
    group, in place (``TorchBatchNorm``'s update)."""
    mean_g, var_g = st[0], torch.clamp(st[4], min=0.0)
    G = mean_g.shape[0]
    with torch.no_grad():
        var_u = var_g * (count / max(count - 1, 1))
        m = momentum
        mean, var = running_mean, running_var
        for g in range(G):
            mean = m * mean + (1 - m) * mean_g[g].to(mean.dtype)
            var = m * var + (1 - m) * var_u[g].to(var.dtype)
        running_mean.copy_(mean)
        running_var.copy_(var)
        num_batches_tracked += G


def bn_relu_backward_reference(g: torch.Tensor, y: torch.Tensor,
                               cb: torch.Tensor, weight: torch.Tensor,
                               st: torch.Tensor, groups: int):
    """The plain backward of :func:`bn_relu_forward_reference` for the
    output gradient ``g``, in closed form: (dy in y's dtype, then the conv
    bias', the BatchNorm weight's and bias' gradients in the statistics'
    dtype). The ReLU's mask is recomputed from y in the forward's
    roundings; with ``go`` the gradient where the output is positive,
    S1 = sum go and S2 = sum go * (z - mean) a group and channel, the
    input gradient is ``go * mul + A + B * (z - mean)`` (the means' and
    the variance's terms). Autograd sums go * z instead: the same in exact
    arithmetic, and centred sums do not cancel where a mean is large."""
    dt = y.dtype
    sdt = st.dtype
    mean, inv, mul, add, d = st.unbind(0)
    zg = _grouped(y + cb.view(1, -1, *(1,) * (y.dim() - 2)), groups)
    red = (1,) + tuple(range(3, zg.dim()))
    o = zg * _per_group(mul.to(dt), zg) + _per_group(add.to(dt), zg)
    go = torch.where(o <= 0, 0.0, _grouped(g, groups).to(sdt))
    zc = zg.to(sdt) - _per_group(mean, zg)
    s1, s2 = go.sum(dim=red), (go * zc).sum(dim=red)
    scale = weight.to(sdt)[None]
    M = zg[0, :, 0].numel()
    dweight = (s2 * inv).sum(0)
    dbias = s1.sum(0)
    g_inv = s2 * scale
    g_mean = -s1 * inv * scale
    g_var = torch.where(d >= 0, -0.5 * g_inv * inv ** 3, 0.0)
    dz = (go * _per_group(mul, zg) + _per_group(g_mean / M, zg)
          + _per_group(2.0 * g_var / M, zg) * zc).to(dt)
    dims = (0,) + tuple(range(2, y.dim()))
    dy = dz.reshape(y.shape)
    return dy, dy.to(sdt).sum(dim=dims), dweight, dbias


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` dense channels_last on a 16-byte boundary (a copy only where
    it is not)."""
    fmt = _LAYOUTS[t.dim()]
    if t.is_contiguous(memory_format=fmt) and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=fmt)


def _launch_shape(y: torch.Tensor, groups: int):
    C = y.shape[1]
    rows = y.numel() // C
    if y.shape[0] % groups:
        raise ValueError(f"batch {y.shape[0]} does not split into {groups} "
                         f"groups")
    rows_g = rows // groups
    chunks, ctile = bn_geometry(rows_g, C, groups,
                                _sm_count(y.device.index or 0))
    return rows_g, C, chunks, ctile


def _check(y: torch.Tensor, cb: torch.Tensor, what: str,
           params: Sequence[torch.Tensor] = (),
           st: Optional[torch.Tensor] = None, groups: int = 1,
           count: Optional[torch.Tensor] = None) -> None:
    """Refuses a call whose tensors the kernels would misread: ``y`` as
    :func:`fused_route` takes it, dense channels_last on a 16-byte
    boundary; the conv bias ``cb`` bf16 and dense, ``params`` f32 and
    dense (both of C, on y's device); the statistics ``st`` f32 (5, G, C);
    ``count`` (num_batches_tracked) int64."""
    C = y.shape[1] if y.dim() > 1 else 0
    fmt = _LAYOUTS.get(y.dim())
    dense = (lambda t, dt, shape: t.dtype == dt and t.shape == shape
             and t.is_contiguous() and t.device == y.device)
    if not (fused_route(y, None, params)
            and y.is_contiguous(memory_format=fmt)
            and y.data_ptr() % 16 == 0
            and dense(cb, torch.bfloat16, (C,))
            and (st is None or dense(st, torch.float32, (5, groups, C)))
            and (count is None or dense(count, torch.int64, ()))):
        raise ValueError(
            f"{what}: the kernels take a dense channels_last bf16 y with "
            f"C % 8 == 0 on a 16-byte boundary on the card, outside a world "
            f"of several ranks, with a bf16 conv bias and f32 parameters, "
            f"statistics and running averages of C on its device; got y "
            f"{y.dtype} {tuple(y.shape)} strides {y.stride()} on {y.device}"
            f", conv bias {cb.dtype} on {cb.device}, parameters "
            f"{[(p.dtype, tuple(p.shape), str(p.device)) for p in params]}")


def bn_relu_stats(y: torch.Tensor, cb: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor, running, groups: int, eps: float,
                  momentum: float) -> torch.Tensor:
    """The (5, G, C) f32 statistics of ``y + cb`` on the card, and with
    ``running`` = (running_mean, running_var, num_batches_tracked) their
    update, in place (kernels ``batch_norm_relu_stats`` and ``_finalize``).
    """
    rm, rv, nbt = running if running is not None else (None,) * 3
    _check(y, cb, "bn_relu_stats",
           (weight, bias) + ((rm, rv) if running is not None else ()),
           count=nbt)
    rows_g, C, chunks, ctile = _launch_shape(y, groups)
    dev = y.device
    part = torch.empty((groups * chunks, 2, C), dtype=torch.float32,
                       device=dev)
    st = torch.empty((5, groups, C), dtype=torch.float32, device=dev)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    code = kernels.library("batch_norm_relu").batch_norm_relu_stats_bf16(
        y.data_ptr(), cb.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        ptr(rm), ptr(rv), ptr(nbt), part.data_ptr(), st.data_ptr(), rows_g,
        C, groups, chunks, ctile, eps, momentum, 1 - momentum,
        rows_g / max(rows_g - 1, 1), int(running is not None),
        kernels.stream_handle(dev))
    kernels.check(code, "bn_relu_stats")
    kernels.count_launch(bn_relu_stats)
    return st


def bn_relu_apply(y: torch.Tensor, cb: torch.Tensor, st: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """``relu(bf16(bf16((y + cb) * mul) + add))`` on the card with mul and
    add from the statistics ``st`` (kernel ``batch_norm_relu_apply``); the
    output has y's layout."""
    _check(y, cb, "bn_relu_apply", st=st, groups=groups)
    rows_g, C, chunks, ctile = _launch_shape(y, groups)
    out = torch.empty_like(y)
    code = kernels.library("batch_norm_relu").batch_norm_relu_apply_bf16(
        y.data_ptr(), cb.data_ptr(), st.data_ptr(), out.data_ptr(), rows_g,
        C, groups, chunks, ctile, kernels.stream_handle(y.device))
    kernels.check(code, "bn_relu_apply")
    kernels.count_launch(bn_relu_apply)
    return out


def bn_relu_grad(g: torch.Tensor, y: torch.Tensor, cb: torch.Tensor,
                 weight: torch.Tensor, st: torch.Tensor, groups: int):
    """The backward on the card (kernels ``batch_norm_relu_grad_reduce``,
    ``_grad_finalize``, ``_grad_apply``, ``_bias_grad``): dy (bf16, y's
    layout) and the conv bias', BatchNorm weight's and bias' gradients
    (f32)."""
    _check(y, cb, "bn_relu_grad", (weight,), st=st, groups=groups)
    g = _dense(g)
    if g.shape != y.shape or g.dtype != y.dtype:
        raise ValueError(f"bn_relu_grad: gradient {g.dtype} "
                         f"{tuple(g.shape)} for y {y.dtype} "
                         f"{tuple(y.shape)}")
    rows_g, C, chunks, ctile = _launch_shape(y, groups)
    dev = y.device
    part = torch.empty((groups * chunks, 2, C), dtype=torch.float32,
                       device=dev)
    gc = torch.empty((2, groups, C), dtype=torch.float32, device=dev)
    grads = torch.empty((3, C), dtype=torch.float32, device=dev)
    dy = torch.empty_like(y)
    code = kernels.library("batch_norm_relu").batch_norm_relu_backward_bf16(
        g.data_ptr(), y.data_ptr(), cb.data_ptr(), weight.data_ptr(),
        st.data_ptr(), part.data_ptr(), gc.data_ptr(), dy.data_ptr(),
        grads[1].data_ptr(), grads[2].data_ptr(), grads[0].data_ptr(),
        rows_g, C, groups, chunks, ctile, kernels.stream_handle(dev))
    kernels.check(code, "bn_relu_grad")
    kernels.count_launch(bn_relu_grad)
    return dy, grads[0], grads[1], grads[2]


#: kernel launches; a caller sets them to 0 before the run it counts
bn_relu_stats.launches = 0
bn_relu_apply.launches = 0
bn_relu_grad.launches = 0


class BnReLUFunction(torch.autograd.Function):
    """``relu(TorchBatchNorm(y + conv_bias))`` in train mode with the
    closed-form backward: the kernels on a CUDA tensor, the plain version
    on a CPU one. ``running`` is (running_mean, running_var,
    num_batches_tracked) to update, or None (the teacher's forward, a
    rematerialised one). Saves y and the statistics only."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, conv_bias: torch.Tensor,
                weight: torch.Tensor, bias: torch.Tensor, running,
                groups: int, eps: float, momentum: float) -> torch.Tensor:
        cb = conv_bias.to(y.dtype)
        if y.is_cuda:
            y = _dense(y)
            st = bn_relu_stats(y, cb, weight, bias, running, groups, eps,
                               momentum)
            out = bn_relu_apply(y, cb, st, groups)
        else:
            out, st = bn_relu_forward_reference(y, cb, weight, bias, groups,
                                                eps)
            if running is not None:
                update_running_reference(
                    *running, st, y[0, 0].numel() * (y.shape[0] // groups),
                    momentum)
        ctx.save_for_backward(y, cb, weight, st)
        ctx.groups, ctx.bias_dtype = groups, conv_bias.dtype
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        y, cb, weight, st = ctx.saved_tensors
        if y.is_cuda:
            dy, dcb, dw, db = bn_relu_grad(g, y, cb, weight, st, ctx.groups)
        else:
            dy, dcb, dw, db = bn_relu_backward_reference(g, y, cb, weight, st,
                                                         ctx.groups)
        need = ctx.needs_input_grad
        return (dy if need[0] else None,
                dcb.to(ctx.bias_dtype) if need[1] else None,
                dw.to(weight.dtype) if need[2] else None,
                db.to(weight.dtype) if need[3] else None,
                None, None, None, None)
