"""On the card: the check's control (the plain reference in fp8 in the
program's place) and the planted faults fail the cell's limits, and the
reference rounded to bf16 (the witness of what rounding alone does)
passes them, at the cells' own patch and batch on fewer volumes. Run
there with ``python -m pytest -p no:cacheprovider -m cuda
benchmark/tests``."""

from __future__ import annotations

import pytest
import torch

from bench_helpers import ROOT
from benchmark import control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cells' "
                    "own sizes)")
    return torch.device("cuda")


def _fails(nums, limits):
    return any(nums[k] > lim for k, lim in limits.items())


@pytest.mark.cuda
def test_train_control_and_faults_fail(card):
    cell = harness.Registry(ROOT).cell("unet3d_la.self_k4")
    cfg = harness.merged_config(cell, {"data": {"train_volumes": 12}})
    got = control.train_readings(cfg, 2**31 + 101, card,
                                 int(cell.workload["checked_steps"]),
                                 control.warm_group(cell.workload))
    _judge(got, cell.workload["limits"])


def _judge(got, limits):
    for kind, nums in got.items():
        assert _fails(nums, limits) == (kind != "bf16"), (kind, nums)


@pytest.mark.cuda
def test_infer_control_and_faults_fail(card):
    cell = harness.Registry(ROOT).cell("vnet_la.infer")
    cfg = harness.merged_config(cell)
    got = control.infer_readings(cfg, 2**31 + 102, card, volumes=1)
    _judge(got, cell.workload["limits"])
