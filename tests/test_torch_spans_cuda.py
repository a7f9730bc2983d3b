"""The port's spans on the card: in a trace of CPU and CUDA activity, a
replayed dispatch group's graph launches sit inside ``step.teacher`` and
``step.update`` and the kernels of each replay carry its launch's
correlation, so device time is attributed to the span that replayed it.
Every test here needs a CUDA device and skips without one; the file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_spans_cuda.py
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bcp_tpu_torch.config import la_config
from bcp_tpu_torch.train.graphs import DispatchGroups
from bcp_tpu_torch.train.state import init_state
from bcp_tpu_torch.train.trainer import copy_paste_box, iteration_draws

pytestmark = pytest.mark.cuda

K = 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the hand-written "
                    "kernels have no CPU mode")
    return torch.device("cuda")


def _stacked(cfg, dev, seed):
    g = torch.Generator().manual_seed(seed)
    S = tuple(cfg.patch_size)
    out = {}
    for k in ("a", "b"):
        lab = torch.randint(0, 2, (K, 1, *S), generator=g)
        out[f"lab_{k}"] = lab.to(dev, torch.uint8)
        out[f"img_{k}"] = (torch.randn((K, 1, 1, *S), generator=g) * 0.3
                           + lab[:, :, None]).to(dev, torch.bfloat16)
        out[f"uimg_{k}"] = (torch.randn((K, 1, 1, *S), generator=g) * 0.5
                            + 0.5).to(dev, torch.bfloat16)
    return out


def test_replayed_group_kernels_correlate_to_their_spans(cuda_device,
                                                         tmp_path):
    dev = cuda_device
    cfg = la_config(labelnum=4, n_filters=16, patch_size=(16,) * 3,
                    batch_size=4, labeled_bs=2, compute_dtype="bfloat16")
    state = init_state(cfg, dev)
    gen = torch.Generator(device=dev)

    def draws(it):
        return copy_paste_box(cfg, iteration_draws(7, it, gen)), gen

    groups = DispatchGroups(state, cfg, "self", K, draws)
    # eager, then the captures, then a replayed group under the profiler
    for g in range(2):
        groups.run(_stacked(cfg, dev, g), 1 + g * K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        groups.run(_stacked(cfg, dev, 2), 1 + 2 * K)
        torch.cuda.synchronize()
    groups.close()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in ("step.teacher", "step.update")]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "GraphLaunch" in e["name"]]
    assert sorted(e["name"] for e in spans) == \
        ["step.teacher"] * K + ["step.update"] * K
    assert len(launches) == 2 * K
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            corr = e.get("args", {}).get("correlation")
            kernels[corr] = kernels.get(corr, 0) + 1
    per_span = {"step.teacher": 0, "step.update": 0}
    for launch in launches:
        (inside,) = [s for s in spans if s["tid"] == launch["tid"]
                     and s["ts"] <= launch["ts"] < s["ts"] + s["dur"]]
        n = kernels.get(launch["args"]["correlation"], 0)
        assert n > 0, ("no kernel carries the graph launch's correlation",
                       inside["name"])
        per_span[inside["name"]] += n
    # the update (forward, backward, SGD, EMA) runs more kernels than the
    # teacher's forward
    assert per_span["step.update"] > per_span["step.teacher"] > 0
