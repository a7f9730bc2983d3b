"""``steps_per_dispatch`` on the card: the CUDA graph step of
``train.graphs`` against the eager step for LA, ACDC and pancreas at a
tiny size (LA also with the fused backward), graph S captured again at
an LR boundary while a validation runs, and Adam's ``capturable``
hand-off from a checkpoint written on the CPU. Every test here needs a CUDA device and skips without one; the file
imports neither jax nor the JAX package, so it runs on the GPU host:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_dispatch_cuda.py
"""

import numpy as np
import pytest
import torch

from bcp_tpu_torch import kernels
from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.data.datasets import VolumeList
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.train.graphs import DispatchGroups
from bcp_tpu_torch.train.state import (init_state, load_optimizer,
                                       load_with_opt)
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import (BCPTrainer, copy_paste_box,
                                         copy_paste_mask, iteration_draws)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written "
                    "kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


#: n_filters 16 so the V-Nets' 3^3 convs run on kernels B and C
TINY = {
    "la": lambda: la_config(labelnum=4, n_filters=16, patch_size=(16,) * 3,
                            batch_size=4, labeled_bs=2,
                            compute_dtype="bfloat16"),
    # the fused backward (kernel D) captured in place of B-as-dx then C
    "la_fused": lambda: TINY["la"]().replace(fused_bwd=True),
    # f32: the U-Net's bilinear upsample adds its gradient with atomics,
    # whose order a run does not fix; in bf16 that noise alone moves six
    # tiny steps by more than REL
    "acdc": lambda: acdc_config(labelnum=1, n_filters=16,
                                patch_size=(32, 32), batch_size=4,
                                labeled_bs=2, compute_dtype="float32"),
    "pancreas": lambda: pancreas_config(20, n_filters=16,
                                        patch_size=(16,) * 3, mask_patch=8,
                                        batch_size=4, labeled_bs=2,
                                        compute_dtype="bfloat16"),
    # a grid mask's boxes painted on the host and copied through pinned
    # buffers into the static mask, and a slab mask
    "la_grid": lambda: TINY["la"]().replace(mask_kind="grid"),
    "acdc_grid": lambda: TINY["acdc"]().replace(mask_kind="grid"),
    "pancreas_grid": lambda: TINY["pancreas"]().replace(mask_kind="grid"),
    "la_slab": lambda: TINY["la"]().replace(mask_kind="slab"),
}


def _batches(cfg, n, stage, dev, seed=0):
    rng = np.random.default_rng(seed)
    S = tuple(cfg.patch_size)
    dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
          else torch.float32)
    out = []
    for _ in range(n):
        b = {}
        for k in ("a", "b"):
            lab = rng.integers(0, cfg.num_classes, (1, *S))
            b[f"lab_{k}"] = torch.from_numpy(lab.astype(np.uint8)).to(dev)
            b[f"img_{k}"] = torch.from_numpy(
                rng.normal(0, 0.3, (1, 1, *S)) + lab[:, None]).to(dev, dt)
            if stage == "self":
                b[f"uimg_{k}"] = torch.from_numpy(
                    rng.normal(0.5, 0.5, (1, 1, *S))).to(dev, dt)
        out.append(b)
    return out


def _tensors(state):
    """name -> tensor of the student, the teacher and the optimizer state
    (by its parameter's name)."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    names = [n for n, _ in state.model.named_parameters()]
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{names[i]}.{k}": v for k, v in st.items()})
    return out


def _eager(cfg, stage, batches, dev, seed):
    state = init_state(cfg, dev)
    gen = torch.Generator(device=dev)
    losses = []
    for it, b in enumerate(batches, start=1):
        mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen), dev)
        m = pretrain_step(state, b, mask, cfg, gen) if stage == "pre" \
            else selftrain_step(state, b, mask, cfg, gen, gen)
        losses.append({k: float(v) for k, v in m.items()})
    return state, losses


#: where two eager steps from one state differ, a graph step's update of a
#: tensor may differ from the eager step's by this share of the largest
#: eager update among its module's tensors of the same kind
#: (``chip_smoke.py``'s STEP_REL)
REL = 0.15


def _same(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                          for k in a)


def _clone(state):
    return {k: v.clone() for k, v in _tensors(state).items()}


def _load(state, tensors):
    """Set ``state`` (a fresh ``init_state`` of the same config, stepped
    once so its optimizer state exists) to ``tensors``."""
    for k, v in _tensors(state).items():
        v.copy_(tensors[k])


def _hold_step(start, got, want, exact):
    """One step's updates from ``start``: bit for bit where ``exact`` and
    for every running statistic and integer (the forward is
    deterministic), else each within REL of the largest eager update of
    its module and kind (an optimizer statistic shares its parameter's
    module)."""
    def kind(k):
        if k.startswith("opt."):
            name, stat = k.rsplit(".", 1)
            return name.rsplit(".", 1)[0], stat
        return k.rsplit(".", 1)[0], "running" in k
    scale = {}
    for k, v in want.items():
        if v.is_floating_point():
            d = (v.double() - start[k].double()).abs().max().item()
            scale[kind(k)] = max(scale.get(kind(k), 0.0), d)
    for k, v in want.items():
        if exact or not v.is_floating_point() or "running" in k:
            assert torch.equal(got[k], v), k
            continue
        err = (got[k].double() - v.double()).abs().max().item()
        assert err <= REL * scale[kind(k)] + 1e-12, (k, err, scale[kind(k)])


def _groups(cfg, stage, dev, seed):
    state = init_state(cfg, dev)
    gen = torch.Generator(device=dev)

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(seed, it, gen)), gen
    return state, DispatchGroups(state, cfg, stage, 2, draws), draws


def _stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("variant", ["la", "la_fused", "acdc", "pancreas",
                                     "la_grid", "acdc_grid", "pancreas_grid",
                                     "la_slab"])
@pytest.mark.parametrize("stage", ["pre", "self"])
def test_graph_step_equals_eager_step(cuda_device, variant, stage):
    """Three groups of K = 2, the first eager, the others CUDA graph
    replays, against six eager steps with the same draws (cuDNN held to
    its deterministic algorithms): the captures and replays expected, the
    kernels' launch counts of the eager run, and, where two eager runs
    agree bit for bit (every variant but ACDC, whose bilinear upsample adds
    its gradient with atomics), the same student, teacher, optimizer state
    and losses bit for bit. ACDC's steps are held one by one, from one
    state, by the next test."""
    torch.backends.cudnn.deterministic = True
    try:
        cfg = TINY[variant]()
        seed = cfg.seed + (stage == "self")
        batches = _batches(cfg, 6, stage, cuda_device)
        before = kernels.launch_counts()
        want_state, want = _eager(cfg, stage, batches, cuda_device, seed)
        torch.cuda.synchronize()
        eager_launches = {k: v - before.get(k, 0)
                          for k, v in kernels.launch_counts().items()}
        again_state, again = _eager(cfg, stage, batches, cuda_device, seed)
        state, groups, _ = _groups(cfg, stage, cuda_device, seed)
        before = kernels.launch_counts()
        got = []
        for g in range(3):
            names, values = groups.run(
                _stacked(batches[2 * g:2 * g + 2]), 2 * g + 1)
            got += [dict(zip(names, r)) for r in values.tolist()]
        torch.cuda.synchronize()
        graph_launches = {k: v - before.get(k, 0)
                          for k, v in kernels.launch_counts().items()}
        counts = groups.close()
    finally:
        torch.backends.cudnn.deterministic = False
    assert counts == {"captures": 1 if stage == "pre" else 2,
                      "replays": 4 if stage == "pre" else 8}
    assert state.step == want_state.step == 6
    assert {k: v for k, v in graph_launches.items() if v} == {
        k: v for k, v in eager_launches.items() if v}
    want_t = _tensors(want_state)
    if again == want and _same(_tensors(again_state), want_t):
        assert got == want
        assert _same(_tensors(state), want_t)
    else:
        assert variant.startswith("acdc")
        assert np.isfinite([v for m in got for v in m.values()]).all()


@pytest.mark.parametrize("variant", ["la", "acdc", "pancreas"])
@pytest.mark.parametrize("stage", ["pre", "self"])
def test_graph_step_matches_eager_step_from_its_state(cuda_device, variant,
                                                      stage):
    """After an eager warm-up group, each of two graph steps beside an
    eager step from the state it started from, with the same batch and
    draws: the losses and the running statistics bit for bit (the forward
    is deterministic); the updates bit for bit where a second eager step
    from that state is, else within REL."""
    cfg = TINY[variant]()
    seed = cfg.seed + (stage == "self")
    batches = _batches(cfg, 4, stage, cuda_device)
    state, groups, draws = _groups(cfg, stage, cuda_device, seed)
    groups.run(_stacked(batches[:2]), 1)
    step = groups.graph_step
    eager = init_state(cfg, cuda_device)
    gen = torch.Generator(device=cuda_device)
    # a first eager step creates the optimizer state that _load overwrites
    pretrain_step(eager, batches[0], copy_paste_mask(
        cfg, iteration_draws(seed, 1, gen), cuda_device), cfg, gen) \
        if stage == "pre" else selftrain_step(
            eager, batches[0], copy_paste_mask(
                cfg, iteration_draws(seed, 1, gen), cuda_device), cfg, gen,
            gen)
    for it, b in ((3, batches[2]), (4, batches[3])):
        start = _clone(state)
        got = dict(zip(step.names, step.step(b, draws(it)).tolist()))
        after = []
        for _ in range(2):
            _load(eager, start)
            eager.step = it - 1
            mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen),
                                   cuda_device)
            m = pretrain_step(eager, b, mask, cfg, gen) if stage == "pre" \
                else selftrain_step(eager, b, mask, cfg, gen, gen)
            after.append(({k: float(v) for k, v in m.items()},
                          _clone(eager)))
        assert got == after[0][0], it
        _hold_step(start, _tensors(state), after[0][1],
                   exact=_same(after[1][1], after[0][1]))
    groups.close()


def test_recapture_at_an_lr_boundary_while_validating(cuda_device,
                                                      tmp_path):
    """LA's self-train rate falls every ``lr_decay_every`` steps; at 2,
    with K = 2 and a background validation at every group's end, graph S
    is captured at step 3 and again at step 5 (the new rate), each time
    after the trainer's workers are drained. The stage ends in the state
    of K = 1, to within the card's eager-to-eager noise (here: bit for
    bit with cuDNN's deterministic algorithms)."""
    cfg = TINY["la"]().replace(lr_decay_every=2, eval_every=2,
                               pre_iterations=2, self_iterations=6,
                               snapshot_root=str(tmp_path / "k1"))
    data = VolumeList(la_cases(8, (20, 20, 18), seed=11))
    val = la_cases(1, (24, 22, 20), seed=12)
    torch.backends.cudnn.deterministic = True
    try:
        ref = BCPTrainer(cfg, "cuda", data, val)
        ref.pretrain()
        ref.selftrain()
        k2 = BCPTrainer(cfg.replace(steps_per_dispatch=2,
                                    snapshot_root=str(tmp_path / "k2")),
                        "cuda", data, val)
        k2.pretrain()
        k2.selftrain()
    finally:
        torch.backends.cudnn.deterministic = False
    assert k2.graph_counts["self"] == {"captures": 3, "replays": 8}
    assert k2.validations >= 4
    for stage in ("pre_train", "self_train"):
        a = torch.load(tmp_path / "k1" / "LA_BCP_4_labeled" / stage /
                       "last_state.pt", weights_only=False)
        b = torch.load(tmp_path / "k2" / "LA_BCP_4_labeled" / stage /
                       "last_state.pt", weights_only=False)
        assert a["step"] == b["step"]
        for part in ("model", "teacher"):
            for k, v in a[part].items():
                assert torch.equal(v, b[part][k]), (stage, part, k)


def test_adam_capturable_hand_off_from_a_cpu_checkpoint(cuda_device):
    """A pancreas pre-train state written by an eager CPU run (Adam not
    capturable, its step on the CPU) loads into the card's capturable Adam:
    the flag stays on, every step count lands on the card, and the
    self-train stage's graphs capture and replay from it."""
    cfg = TINY["pancreas"]()
    cpu = init_state(cfg, "cpu")
    batch = {k: v.cpu() for k, v in _batches(cfg, 1, "pre", "cpu")[0]
             .items()}
    gen = torch.Generator()
    for it in (1, 2):
        pretrain_step(cpu, batch, copy_paste_mask(
            cfg, iteration_draws(cfg.seed, it, gen)), cfg, gen)
    opt_state = cpu.optimizer.state_dict()
    assert opt_state["param_groups"][0]["capturable"] is False
    state = init_state(cfg, cuda_device)
    load_with_opt(state, cpu.model.state_dict(), opt_state)
    assert all(g["capturable"] for g in state.optimizer.param_groups)
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert steps and all(s.device.type == "cuda" and int(s) == 2
                         for s in steps)
    gen = torch.Generator(device=cuda_device)
    seed = cfg.seed + 1

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(seed, it, gen)), gen
    groups = DispatchGroups(state, cfg, "self", 2, draws)
    batches = _batches(cfg, 4, "self", cuda_device)
    for g in range(2):
        part = batches[2 * g:2 * g + 2]
        names, values = groups.run(
            {k: torch.stack([b[k] for b in part]) for k in part[0]},
            2 * g + 1)
        assert np.isfinite(values.cpu().numpy()).all()
    assert groups.close() == {"captures": 2, "replays": 4}
    assert all(int(s["step"]) == 6 for s in state.optimizer.state.values())
    # and back: the card's state loads into a CPU Adam, not capturable
    back = init_state(cfg, "cpu")
    load_optimizer(back.optimizer, state.optimizer.state_dict())
    assert not back.optimizer.param_groups[0]["capturable"]
    assert all(s["step"].device.type == "cpu"
               for s in back.optimizer.state.values())
