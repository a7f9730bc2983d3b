"""What the benchmark hands both sides and what it counts, held bit for bit
to the values the harness gave before the reference architectures became
files of their own: the seeded weights, one iteration's keep masks and
the operations of a recorded step and volume. A digest is the sha256 of
the tensors' bytes, one tensor after another in name (or draw) order."""

from __future__ import annotations

import hashlib

import pytest
import torch

from bench_helpers import SEED, dry_out
from benchmark import data
from benchmark.reference import bcp, nets

VNET_LA = {"n_filters": 16, "n_classes": 2}
UNET3D_LA = {"feat_channels": [64, 256, 256, 512, 1024], "n_classes": 2}
PATCH = (112, 112, 80)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("net,widths,want", [
    ("vnet", VNET_LA,
     "b13f1656022690f57fc07ae8ad0dc765a819bca844d104a2cf92b75df2616b21"),
    ("unet3d", UNET3D_LA,
     "36268e29944362efd9baae634525521e2c51ee07405515aa96fac06ffbe6e73b"),
    ("vnet", {"n_filters": 4, "n_classes": 2},
     "23416c6e872236d11863e0c496364871a6a518122ec05e3db25b14a46da0da6c"),
    ("unet3d", {"feat_channels": [8, 16, 16, 24, 32], "n_classes": 2},
     "602aa0633b61ba998befb12979150c1fcebf1ecfa711825a6a1157a93f61e6d5")])
def test_seeded_weights(net, widths, want):
    sd = data.seeded_weights(net, widths, SEED, "cpu")
    assert digest([sd[k] for k in sorted(sd)]) == want


@pytest.mark.parametrize("net,widths,want", [
    ("vnet", VNET_LA,
     "8397314c82fbd13d07a1f772d62728ba1ea0235f6f7b8a78088189ce454bd48e"),
    ("unet3d", UNET3D_LA,
     "20fef1a6f7257545de2b79da12ccb946c1f9d7eb860674218258fcee9d46b4eb")])
def test_keep_masks_of_one_iteration(net, widths, want):
    """The teacher's and the student's masks of iteration 1, as
    ``SelfTrain.step`` draws them for 4 + 4 samples."""
    gen = torch.Generator()
    gen.manual_seed(bcp.dropout_seed(SEED + 1, 1))
    drops = nets.dropout_shapes(net, widths, PATCH, 4)
    masks = bcp.keep_masks(gen, drops, "cpu") + bcp.keep_masks(gen, drops,
                                                               "cpu")
    assert digest(masks) == want


def test_operations_of_a_recorded_step_and_volume(vnet_root):
    _, out = dry_out("vnet_la.self_k4", root=vnet_root)
    assert out["ctx"]["step_flops"] == 2682257408
    assert out["ctx"]["config"]["reference_net"] == "vnet"
    assert out["ctx"]["workload"]["driver"] == "train"
    _, out = dry_out("vnet_la.infer")
    assert out["ctx"]["volume_flops"] == 1355284480.0
    assert out["ctx"]["workload"]["driver"] == "infer"
