"""``tests/test_torch_spatial_zoo.py``'s split updates for the 2-D
``unet_2d_bcp`` and ``unet_tsne`` through the ACDC steps at 32x32 (the
rows split: slabs of 16 down to 1, every level sliced, the element-wise
dropouts keeping their slab of the whole draw), with the same tolerances,
in a spawned world of two gloo ranks of its own."""

import pytest

from test_torch_spatial_zoo import cases, hold_split, split_runs
from torch_port_helpers import ZOO

import torch_spatial_ranks as sr

#: case name -> (net type, factory kwargs, patch, ZOO fixture)
NETS = {name: (name, ZOO[name][0], sr.P2, name)
        for name in ("unet_2d_bcp", "unet_tsne")}


@pytest.fixture(scope="module")
def runs():
    return split_runs(NETS)


@pytest.mark.parametrize("case", cases(NETS))
def test_zoo_split_update(runs, case):
    hold_split(runs, case, NETS[case.split("-")[0]][0])
