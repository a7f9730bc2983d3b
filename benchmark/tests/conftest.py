"""Fixtures of the benchmark's CPU tests."""

import pytest

from bench_helpers import root_with_vnet_train


@pytest.fixture(scope="session")
def vnet_root(tmp_path_factory):
    """A benchmark copy that also holds the dry-run V-Net train cell."""
    return root_with_vnet_train(tmp_path_factory.mktemp("vnet"))
