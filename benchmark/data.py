"""What the benchmark hands to both sides, made from the seed on the
device: blob volumes (the port's ``data/synthetic.py::blob_volume``
pattern, vectorised: noise of sd 0.3 with one bright ellipsoid, its
voxels the foreground class) and the seeded weights of a reference net.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import nets

#: volumes generated per call, to bound the device memory of set-up
CHUNK = 8


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of the run's streams (volumes,
    weights, ...), from the seed."""
    words = np.random.SeedSequence([seed, stream]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 32 | int(words[1]))
    return g


def blob_volumes(seed: int, stream: int, n: int, shape: Sequence[int],
                 device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` (image f32, label uint8) volumes of ``shape`` on the host."""
    g = generator(seed, stream, device)
    shape = tuple(int(s) for s in shape)
    ext = torch.tensor(shape, dtype=torch.float32, device=device)
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in shape]
    out = []
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        img = torch.randn((m, *shape), generator=g, device=device) * 0.3
        u = torch.rand((m, 2, 3), generator=g, device=device)
        centre = (0.3 + 0.4 * u[:, 0]) * ext
        radii = torch.clamp((0.12 + 0.10 * u[:, 1]) * ext, min=2.0)
        d = sum((((axes[a] - centre[:, a, None]) / radii[:, a, None]) ** 2)
                .view(m, *[-1 if b == a else 1 for b in range(3)])
                for a in range(3))
        blob = d <= 1.0
        img = img + 1.2 * blob
        for i, b in zip(img.cpu().numpy(), blob.to(torch.uint8).cpu()
                        .numpy()):
            out.append((i, b))
    return out


#: the run's random streams from the seed (``generator``'s ``stream``):
#: 0 the train volumes, 1 the conv and linear weights, 2 the other free
#: parameters, 3 the validation volumes, 4 the test volumes
WEIGHTS, FREE = 1, 2

#: modules whose weight and bias are drawn uniform in +-1/sqrt(fan_in)
MATMULS = (torch.nn.Conv3d, torch.nn.ConvTranspose3d, torch.nn.Linear)

#: norms, whose affine scale is 1 and shift 0
NORMS = (torch.nn.modules.batchnorm._NormBase, torch.nn.LayerNorm,
         torch.nn.GroupNorm)


def seed_free(named, gen: torch.Generator) -> None:
    """The free parameters ((name, tensor) pairs), N(0, 0.02^2) in one
    draw."""
    total = sum(t.numel() for _, t in named)
    z = torch.randn(total, generator=gen, device=gen.device) * 0.02
    at = 0
    for _, t in named:
        t.copy_(z[at:at + t.numel()].view(t.shape))
        at += t.numel()


def seeded_weights(net: str, widths: dict, seed: int, device,
                   calibrate: Optional[torch.Tensor] = None):
    """A state_dict of the reference net ``net`` drawn from the seed, every
    parameter: each conv's and linear layer's weight and bias uniform in
    +-1/sqrt(fan_in) (torch's default bound), in module order, in one
    call of stream :data:`WEIGHTS`; each norm's scale 1 and shift 0;
    every other parameter (embeddings, tables) in name order from stream
    :data:`FREE`, by the architecture file's ``seed_free`` or
    :func:`seed_free`. A parameter none of these draws is an error. With
    ``calibrate``, an input batch, each BatchNorm's running statistics
    are set to its input's batch statistics in one f32 forward of it, so
    that an eval-mode net's activations stay at unit scale."""
    model = nets.build(net, widths).to(device)
    mats = [m for m in model.modules() if isinstance(m, MATMULS)]
    tensors = [t for m in mats for t in (m.weight, m.bias) if t is not None]
    total = sum(t.numel() for t in tensors)
    u = torch.rand(total, generator=generator(seed, WEIGHTS, device),
                   device=device) * 2 - 1
    drawn = {id(t) for t in tensors}
    with torch.no_grad():
        at = 0
        for m in mats:
            bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
            for t in (m.weight, m.bias):
                if t is None:
                    continue
                t.copy_(u[at:at + t.numel()].view(t.shape) * bound)
                at += t.numel()
        for m in model.modules():
            if isinstance(m, NORMS):
                for t, value in ((m.weight, 1.0), (m.bias, 0.0)):
                    if t is not None:
                        t.fill_(value)
                        drawn.add(id(t))
        free = sorted(((n, p) for n, p in model.named_parameters()
                       if id(p) not in drawn and p.is_floating_point()),
                      key=lambda item: item[0])
        if free:
            fill = getattr(nets.arch(net), "seed_free", seed_free)
            fill(free, generator(seed, FREE, device))
            drawn.update(id(p) for _, p in free)
    left = [n for n, p in model.named_parameters() if id(p) not in drawn]
    if left:
        raise ValueError(f"{net}: parameters no draw covers: {left}")
    if calibrate is not None:
        def set_stats(mod, inputs):
            v = inputs[0]
            mod.running_mean.copy_(v.mean(dim=(0, 2, 3, 4)))
            mod.running_var.copy_(v.var(dim=(0, 2, 3, 4)))

        hooks = [m.register_forward_pre_hook(set_stats)
                 for m in model.modules()
                 if isinstance(m, torch.nn.BatchNorm3d)]
        with torch.no_grad():
            model.eval()(calibrate.to(device))
        for h in hooks:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
