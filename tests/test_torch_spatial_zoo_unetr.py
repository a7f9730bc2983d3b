"""``tests/test_torch_spatial_zoo.py``'s split updates for UNETR and
UNETR_DTC through the LA steps at their window, with the same tolerances,
in a spawned world of two gloo ranks of its own.

UNETR twice: at ``ZOO``'s 16^3 window, whose token grid has one plane in
x, so the token levels and the decoder's first level above it run
replicated and the split takes the slabs back at the level of 2 planes;
and at a 32 x 16 x 16 window, whose two token planes split, so every
decoder level runs on slabs and the patch embedding on each rank's slab.
And UNETR at K = 2 against K = 1 under the split, its dropouts on.
"""

import pytest

from test_torch_spatial_zoo import cases, hold_split, split_runs
from torch_port_helpers import UNETR_KW, ZOO

import torch_spatial_ranks as sr

#: case name -> (net type, factory kwargs, patch, ZOO fixture or None)
NETS = {
    "unetr": ("unetr", UNETR_KW, sr.P3, "unetr"),
    "unetr_grid2": ("unetr", dict(UNETR_KW, img_shape=(32, 16, 16)),
                    (32, 16, 16), None),
    "unetr_dtc": ("unetr_dtc", ZOO["unetr_dtc"][0], sr.P3, "unetr_dtc"),
}


@pytest.fixture(scope="module")
def runs():
    la = [sr.blob_batch("la", 2, sr.P3, seed=40 + i) for i in range(4)]
    kw = dict(sr.TINY["la"], batch_size=4, labeled_bs=2)
    extra = {f"k{K}": ("zoo_dispatch", 2, ("unetr", UNETR_KW, kw, la, K))
             for K in (1, 2)}
    return split_runs(NETS, extra)


@pytest.mark.parametrize("case", cases(NETS))
def test_zoo_split_update(runs, case):
    hold_split(runs, case, NETS[case.split("-")[0]][0])


def test_unetr_k2_equals_k1_under_a_space_split(runs):
    """UNETR, four self-train iterations with its dropouts on: K = 2 (the
    static-buffer bodies, whose keep masks ``draw_keep_masks`` draws ahead
    of the forward: the replicated token dropouts whole) bit for bit K =
    1."""
    two = runs[2]
    for a, b in zip(two["k2"], two["k1"]):
        sr.same(a, b)
