"""K steps per dispatch (``steps_per_dispatch``) in the port, on the CPU at a
tiny size: the ``stack=K`` feed against the JAX package's stacked feed,
the static-buffer step of ``train.graphs`` (the body a CUDA graph
captures, called here on the CPU with pre-drawn keep masks) against the
eager step, the trainer at K = 2 against K = 1, the K = 2 group against
the JAX package's scanned ``n_steps=2`` step, and the refusals."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcp_tpu.config import acdc_config as jax_acdc_config
from bcp_tpu.config import la_config as jax_la_config
from bcp_tpu.config import pancreas_config as jax_pancreas_config
from bcp_tpu.data import feed as jax_feed
from bcp_tpu.data import synthetic as jax_synthetic
from bcp_tpu.data.feed import BCPBatchFeeder as JaxFeeder
from bcp_tpu_torch.cli import train_la
from bcp_tpu_torch.config import acdc_config, la_config, pancreas_config
from bcp_tpu_torch.data import feed
from bcp_tpu_torch.data.datasets import (ACDCDataset, LAHeartDataset,
                                         PancreasDataset, VolumeList)
from bcp_tpu_torch.data.feed import BCPBatchFeeder
from bcp_tpu_torch.data.synthetic import la_cases
from bcp_tpu_torch.ops.masks import cuboid_sizes
from bcp_tpu_torch.train.graphs import DispatchGroups, check_dispatch
from bcp_tpu_torch.train.state import init_state
from bcp_tpu_torch.train.steps import pretrain_step, selftrain_step
from bcp_tpu_torch.train.trainer import (BCPTrainer, copy_paste_box,
                                         copy_paste_mask, iteration_draws)

# ---------------------------------------------------------------------------
# the stacked feed


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    la = tmp_path_factory.mktemp("la")
    jax_synthetic.make_la_dataset(str(la), n_train=8, n_test=1,
                                  shape=(22, 20, 18), seed=11)
    acdc = tmp_path_factory.mktemp("acdc")
    jax_synthetic.make_acdc_dataset(str(acdc), n_train_slices=20, n_val=2,
                                    slice_shape=(40, 36), vol_depth=3,
                                    seed=11)
    panc = jax_synthetic.make_pancreas_dataset(
        str(tmp_path_factory.mktemp("pancreas")), n_lab=4, n_unlab=6,
        n_test=2, shape=(20, 14, 18), seed=5)
    return {"la": str(la), "acdc": str(acdc), "pancreas": panc}


def _feeds(variant, root, store, stage, K, side_labels=False):
    """(JAX feeder, port feeder) of one variant at ``stack=K``."""
    if variant == "la":
        kw = dict(root_path=root, labelnum=4, patch_size=(16, 16, 12))
        jcfg, cfg = jax_la_config(**kw), la_config(**kw)
        data = LAHeartDataset(root, "train", cache=True)
    elif variant == "acdc":
        kw = dict(root_path=root, labelnum=1, patch_size=(32, 32),
                  batch_size=8, labeled_bs=4)
        jcfg, cfg = jax_acdc_config(**kw), acdc_config(**kw)
        data = ACDCDataset(root, "train", cache=True)
    else:
        kw = dict(root_path=root, patch_size=(16, 16, 16))
        jcfg, cfg = jax_pancreas_config(20, **kw), pancreas_config(20, **kw)
        data = (PancreasDataset(root, "train_lab"),
                PancreasDataset(root, "train_unlab"))
    extra = dict(compute_dtype="bfloat16", device_data_cache=store)
    return (JaxFeeder(jcfg.replace(**extra), stage, stack=K),
            BCPBatchFeeder(cfg.replace(**extra), stage, data, device="cpu",
                           stack=K, side_labels=side_labels))


@pytest.mark.parametrize("variant,store,stage", [
    ("la", False, "self"), ("la", True, "self"), ("la", True, "pre"),
    ("acdc", False, "self"), ("acdc", True, "self"),
    ("pancreas", False, "self"), ("pancreas", True, "self")])
def test_stacked_feed_equals_jax_stacked_feed(roots, monkeypatch, variant,
                                              store, stage):
    """``stack=3``: three iterations' batches, leading-stacked, bit for bit
    the JAX feeder's ``stack=3`` batches over more than one epoch, host
    path and device store (the labelled and unlabelled draws interleaved
    per iteration, `tests/test_device_store.py:118-200`)."""
    monkeypatch.setitem(jax_feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    K = 3
    want_feed, got_feed = _feeds(variant, roots[variant], store, stage, K)
    try:
        for _ in range(2):
            want = {k: np.asarray(v.astype(jnp.float32)
                                  if v.dtype == jnp.bfloat16 else v)
                    for k, v in next(want_feed).items()
                    if not k.startswith("ulab")}
            got = next(got_feed)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                w = want[k]
                assert v.shape[0] == K
                if k.startswith(("img", "uimg")):
                    w = np.moveaxis(w, -1, 2)   # K N ...C -> K N C ...
                    assert v.dtype == torch.bfloat16
                    v = v.float()
                else:
                    assert v.dtype == torch.uint8
                np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    finally:
        want_feed.close()
        got_feed.close()


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_side_labels_equal_jax_feeders(roots, monkeypatch, store, K):
    """With ``side_labels`` ACDC's self-train batches carry ``ulab_a`` /
    ``ulab_b``, the JAX feeder's true unlabelled labels bit for bit, host
    path and store, K = 1 and K = 2; without, the batch has no such key
    and the rest is the same."""
    monkeypatch.setitem(jax_feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    monkeypatch.setitem(feed.ACDC_PATIENTS_TO_SLICES, 1, 8)
    want_feed, got_feed = _feeds("acdc", roots["acdc"], store, "self", K,
                                 side_labels=True)
    plain = _feeds("acdc", roots["acdc"], store, "self", K)[1]
    try:
        for _ in range(2):
            want = next(want_feed)
            got, other = next(got_feed), next(plain)
            assert sorted(got) == sorted([*other, "ulab_a", "ulab_b"])
            for k in ("ulab_a", "ulab_b"):
                assert got[k].dtype == torch.uint8
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            for k, v in other.items():
                assert torch.equal(got[k], v), k
    finally:
        want_feed.close()
        got_feed.close()
        plain.close()


# ---------------------------------------------------------------------------
# the static-buffer step against the eager step

TINY = {
    "la": lambda: la_config(labelnum=4, n_filters=4, patch_size=(16,) * 3,
                            batch_size=4, labeled_bs=2,
                            compute_dtype="float32"),
    "acdc": lambda: acdc_config(labelnum=1, n_filters=4, patch_size=(32, 32),
                                batch_size=4, labeled_bs=2,
                                compute_dtype="float32"),
    "pancreas": lambda: pancreas_config(20, n_filters=4,
                                        patch_size=(16,) * 3, mask_patch=8,
                                        batch_size=4, labeled_bs=2,
                                        compute_dtype="float32"),
}


def _batches(cfg, n, stage, seed=0):
    rng = np.random.default_rng(seed)
    S = tuple(cfg.patch_size)
    out = []
    for _ in range(n):
        b = {}
        for k in ("a", "b"):
            b[f"img_{k}"] = torch.from_numpy(
                rng.normal(size=(1, 1, *S)).astype(np.float32))
            b[f"lab_{k}"] = torch.from_numpy(
                rng.integers(0, cfg.num_classes, (1, *S)).astype(np.uint8))
            if stage == "self":
                b[f"uimg_{k}"] = torch.from_numpy(
                    (rng.normal(size=(1, 1, *S)) + 0.5).astype(np.float32))
        out.append(b)
    return out


def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"teacher.{k}": v
                for k, v in state.teacher.state_dict().items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def _assert_same_state(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


@pytest.mark.parametrize("variant", ["la", "acdc", "pancreas"])
@pytest.mark.parametrize("stage", ["pre", "self"])
def test_static_step_equals_eager_step(variant, stage):
    """Two groups of K = 2 with ``static=True``: the first eager (the
    warm-up), the second through ``GraphStep``'s bodies on static buffers
    with the box written in place and the keep masks drawn ahead of the
    forward (teacher's first). Against four K = 1 eager steps drawing from
    the generator inside the forward: the same student, teacher,
    optimizer state and losses, bit for bit."""
    _static_equals_eager(TINY[variant](), stage)


@pytest.mark.parametrize("variant,option", [
    ("la", "grid"), ("acdc", "grid"), ("pancreas", "grid"),
    ("la", "slab"), ("acdc", "slab"), ("pancreas", "slab")])
def test_static_step_equals_eager_step_with_options(variant, option):
    """As above for the self-train step with a grid or slab mask (the
    grid's boxes painted on the host into the static mask)."""
    _static_equals_eager(TINY[variant]().replace(mask_kind=option), "self")


def _static_equals_eager(cfg, stage):
    """Both ways also call the ``before_update`` hook with the same
    iterations, sub-batches, masks and pseudo-labels."""
    seed = cfg.seed + (stage == "self")
    batches = _batches(cfg, 4, stage)
    want_state = init_state(cfg, "cpu")
    gen = torch.Generator()
    want, want_seen, seen = [], [], []

    def hook(log):
        def record(it, sub, mask, plab):
            log.append((it, {k: v.clone() for k, v in sub.items()},
                        mask.clone(), None if plab is None
                        else plab.clone()))
        return record
    for it, b in enumerate(batches, start=1):
        mask = copy_paste_mask(cfg, iteration_draws(seed, it, gen))
        if stage == "pre":
            hook(want_seen)(it, b, mask, None)
            step = pretrain_step(want_state, b, mask, cfg, gen)
        else:
            step = selftrain_step(
                want_state, b, mask, cfg, gen, gen,
                lambda p, it=it, b=b, m=mask: hook(want_seen)(it, b, m, p))
        want.append({k: float(v) for k, v in step.items()})

    state = init_state(cfg, "cpu")
    gen2 = torch.Generator()

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(seed, it, gen2)), gen2
    groups = DispatchGroups(state, cfg, stage, 2, draws, static=True)
    got = []
    for g in range(2):
        stacked = {k: torch.stack([b[k] for b in batches[2 * g:2 * g + 2]])
                   for k in batches[0]}
        names, values = groups.run(stacked, 2 * g + 1, hook(seen))
        got += [dict(zip(names, row)) for row in values.tolist()]
        assert (groups.graph_step is not None)
    keeps = groups.graph_step.keep_s + groups.graph_step.keep_t
    assert (len(keeps) > 0) == (cfg.variant != "pancreas")
    assert groups.close() == {"captures": 0, "replays": 0}
    assert got == want
    _assert_same_state(state, want_state)
    assert [s[0] for s in seen] == [s[0] for s in want_seen] == [1, 2, 3, 4]
    for (_, b, m, p), (_, wb, wm, wp) in zip(seen, want_seen):
        assert torch.equal(m, wm)
        assert (p is None) == (wp is None) == (stage == "pre")
        assert p is None or torch.equal(p, wp)
        for k, v in wb.items():
            assert torch.equal(b[k], v), k


# ---------------------------------------------------------------------------
# the trainer at K = 2 against K = 1

def _train_la(root, K, *extra, **overrides):
    args = train_la.build_parser().parse_args(
        ["--labelnum", "4", "--pre_max_iteration", "4",
         "--self_max_iteration", "4", "--snapshot_root", str(root),
         "--device", "cpu", "--steps_per_dispatch", str(K), *extra])
    logged = []
    trainer = train_la.build_trainer(
        args, train_dataset=VolumeList(la_cases(8, (20, 20, 18), seed=11)),
        val_cases=la_cases(1, (24, 22, 20), seed=12),
        patch_size=(16, 16, 16), n_filters=4, eval_every=2,
        compute_dtype="float32", **overrides)
    trainer.on_metrics = lambda *a: logged.append(a)
    steps = []
    trainer.on_step = lambda *a: steps.append(a)
    out = train_la.run_stages(trainer, args)
    return trainer, out, logged, steps


@pytest.mark.parametrize("cache", ["1", "0"])
def test_trainer_k2_equals_k1(tmp_path, cache):
    """Four steps a stage with a validation at step 2 and 4, device store
    and host feed: K = 2 logs the losses, calls the step hook, writes the
    checkpoints and ends with the state of K = 1, bit for bit."""
    _k2_equals_k1(tmp_path, cache)


def test_trainer_k2_equals_k1_with_grid_mask(tmp_path):
    """The same for a grid-masked run (device store)."""
    _k2_equals_k1(tmp_path, "1", mask_kind="grid")


def _k2_equals_k1(tmp_path, cache, **overrides):
    runs = {K: _train_la(tmp_path / f"k{K}", K, "--device_data_cache",
                         cache, **overrides) for K in (1, 2)}
    assert all(getattr(runs[2][0].cfg, k) == v for k, v in overrides.items())
    assert runs[1][2] == runs[2][2] and len(runs[1][2]) == 8
    assert runs[1][3] == runs[2][3] == [
        (s, i) for s in ("pre", "self") for i in range(1, 5)]
    assert runs[2][0].graph_counts == {
        "pre": {"captures": 0, "replays": 0},
        "self": {"captures": 0, "replays": 0}}
    for stage in ("pre_train", "self_train"):
        d1 = tmp_path / "k1" / "LA_BCP_4_labeled" / stage
        d2 = tmp_path / "k2" / "LA_BCP_4_labeled" / stage
        names = sorted(n for n in os.listdir(d1) if n.endswith((".pth",
                                                                ".pt")))
        assert names == sorted(n for n in os.listdir(d2)
                               if n.endswith((".pth", ".pt")))
        assert "last_state.pt" in names and "VNet_best_model.pth" in names
        for name in names:
            a = torch.load(d1 / name, weights_only=False)
            b = torch.load(d2 / name, weights_only=False)
            if name == "last_state.pt":
                assert a["step"] == b["step"] == 4
                a = {f"{p}.{k}": v for p in ("model", "teacher")
                     for k, v in a[p].items()} | {
                    f"opt.{i}": s["momentum_buffer"]
                    for i, s in a["optimizer"]["state"].items()}
                b = {f"{p}.{k}": v for p in ("model", "teacher")
                     for k, v in b[p].items()} | {
                    f"opt.{i}": s["momentum_buffer"]
                    for i, s in b["optimizer"]["state"].items()}
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("field,value", [("eval_every", 3),
                                         ("pre_iterations", 3)])
def test_refuses_k_that_does_not_divide(tmp_path, field, value):
    """eval_every and the stage's remaining iterations must be multiples
    of K (`trainer.py:319-325`)."""
    cfg = TINY["la"]().replace(steps_per_dispatch=2, eval_every=4,
                               pre_iterations=4, snapshot_root=str(tmp_path))
    cfg = cfg.replace(**{field: value})
    trainer = BCPTrainer(cfg, device="cpu",
                         train_dataset=VolumeList(la_cases(8, (20, 20, 18))),
                         val_cases=la_cases(1, (24, 22, 20)))
    with pytest.raises(ValueError, match="multiples of steps_per_dispatch"):
        trainer.pretrain()
    assert check_dispatch(cfg.replace(steps_per_dispatch=1), 3) == 1


# ---------------------------------------------------------------------------
# the K = 2 group against the JAX package's scanned step

JAX_PATCH, JAX_NF, JAX_K = (16, 16, 16), 4, 2


@pytest.fixture(scope="module", params=["pre", "self"])
def jax_group(request):
    """One ``n_steps=2`` call of the JAX package's scanned step (dropout
    off, float64) from converted-able weights: (stage, start state_dict,
    port batches, mask draws, JAX losses per sub-step, JAX student and
    teacher state_dicts after the group)."""
    from bcp_tpu.models import VNet3D as FlaxVNet3D
    from bcp_tpu.train.state import build_optimizer as jax_build_optimizer
    from bcp_tpu.train.state import init_state as jax_init_state
    from bcp_tpu.train.steps import make_pretrain_step, make_selftrain_step
    from bcp_tpu_torch import convert
    from test_torch_steps import _batch, _f64, _np, _to_port
    from test_torch_train_ops import jax_cuboid_starts

    stage = request.param
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = jax_la_config(n_filters=JAX_NF, patch_size=JAX_PATCH,
                             labelnum=4, compute_dtype="float32")
        fmodel = FlaxVNet3D(n_classes=2, n_filters=JAX_NF,
                            normalization="batchnorm", has_dropout=False)
        tx = jax_build_optimizer(jcfg, stage)
        st = jax_init_state(fmodel, jcfg, jax.random.PRNGKey(3), tx)
        params, stats = _f64(st.params), _f64(st.batch_stats)
        st = st.replace(params=params, batch_stats=stats,
                        teacher_params=_f64(params),
                        teacher_batch_stats=_f64(stats),
                        opt_state=tx.init(params))

        def sd(p, s):
            return convert.state_dict_from_flax(
                _np({"params": p, "batch_stats": s}), dtype=np.float64)
        start = sd(params, stats)
        keys = ["img_a", "img_b", "lab_a", "lab_b"] + (
            ["uimg_a", "uimg_b"] if stage == "self" else [])
        batches = [{k: v.astype(np.float64) if v.dtype == np.float32 else v
                    for k, v in _batch(4 + i).items() if k in keys}
                   for i in range(JAX_K)]
        maker = make_pretrain_step if stage == "pre" else make_selftrain_step
        base_key = jax.random.PRNGKey(7)
        stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *batches)
        st, m = maker(fmodel, tx, jcfg, n_steps=JAX_K)(
            st, stacked, base_key, jnp.int32(1))
        m = _np(m)
        want = [{k: float(v[j]) for k, v in m.items()} for j in range(JAX_K)]
        draws = {}
        for it in range(1, JAX_K + 1):
            key = jax.random.fold_in(base_key, it)
            mask_key = jax.random.split(key, 2 if stage == "pre" else 3)[0]
            draws[it] = (jax_cuboid_starts(mask_key, JAX_PATCH),
                         cuboid_sizes(JAX_PATCH))
        port = [_to_port(b) for b in batches]
        return (stage, start, port, draws, want,
                sd(st.params, st.batch_stats),
                sd(st.teacher_params, st.teacher_batch_stats))
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("static", [False, True])
def test_k2_group_matches_jax_scanned_step(jax_group, static):
    """The port's K = 2 group, as K eager steps (the CPU trainer's path)
    or through ``GraphStep``'s static-buffer bodies (what the card's
    graphs capture), against the JAX package's ``n_steps=2`` scanned step
    from the same converted weights, batches and mask draws
    (``fold_in(base_key, it)``), dropout off, in float64. The tolerances of
    ``tests/test_steps.py::test_steps_per_dispatch_identical``: the first
    sub-step's losses to 1e-6, the second's to rtol 1e-2 / atol 1e-3, the
    student's and teacher's tensors to atol 5e-3."""
    from bcp_tpu_torch.models import VNet3D
    from bcp_tpu_torch.train.graphs import GraphStep
    from bcp_tpu_torch.train.state import TrainState, build_optimizer
    stage, start, port, draws, want, want_sd, want_t = jax_group
    cfg = la_config(n_filters=JAX_NF, patch_size=JAX_PATCH, labelnum=4,
                    compute_dtype="float32")
    nets = []
    for _ in range(2):
        net = VNet3D(n_classes=2, n_filters=JAX_NF).double()
        net.load_state_dict(start, strict=True)
        nets.append(net.train())
    for p in nets[1].parameters():
        p.requires_grad_(False)
    state = TrainState(nets[0], nets[1],
                       build_optimizer(cfg, nets[0].parameters()))
    names = sorted(want[0])
    if static:
        step = GraphStep(state, cfg, stage, port[0], ([], []), names)
        got = [dict(zip(names, step.step(b, ([draws[it]], None)).tolist()))
               for it, b in enumerate(port, start=1)]
    else:
        groups = DispatchGroups(state, cfg, stage, JAX_K,
                                lambda it: ([draws[it]], None), static=False)
        stacked = {k: torch.stack([b[k] for b in port]) for k in port[0]}
        names, values = groups.run(stacked, 1)
        got = [dict(zip(names, row)) for row in values.tolist()]
    assert state.step == JAX_K and len(got) == JAX_K
    for j, (g, w) in enumerate(zip(got, want)):
        tight = j == 0
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(
                g[k], w[k], rtol=1e-6 if tight else 1e-2,
                atol=1e-6 if tight else 1e-3, err_msg=f"{stage}[{j}][{k}]")
    for mod, ref in ((state.model, want_sd), (state.teacher, want_t)):
        for k, v in mod.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(v.detach().numpy(), ref[k].numpy(),
                                       rtol=0.0, atol=5e-3, err_msg=k)


def test_load_optimizer_keeps_the_optimizers_own_capturable():
    """A saved Adam state that says ``capturable: True`` (written on the
    card) loads into a CPU Adam as not capturable, its step counts on the
    CPU, and the next update is the one the saved optimizer would make."""
    from bcp_tpu_torch.train.state import build_optimizer, load_optimizer
    cfg = TINY["pancreas"]()
    w = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
    opt = build_optimizer(cfg, [w])
    assert opt.param_groups[0]["capturable"] is False
    w.grad = torch.ones(6)
    opt.step()
    saved = copy.deepcopy(opt.state_dict())
    saved["param_groups"][0]["capturable"] = True
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = build_optimizer(cfg, [w2])
    load_optimizer(opt2, saved)
    assert opt2.param_groups[0]["capturable"] is False
    assert opt2.state[w2]["step"].device.type == "cpu"
    w.grad, w2.grad = torch.full((6,), 0.5), torch.full((6,), 0.5)
    opt.step()
    opt2.step()
    assert torch.equal(w, w2)
