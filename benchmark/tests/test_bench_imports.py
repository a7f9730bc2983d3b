"""The import guard: what the benchmark runs loads neither JAX nor the
JAX package the port was made from, and the reference imports nothing of
the port. Module names are compared by their top-level name, whole: the
port, ``bcp_tpu_torch``, begins with the JAX package's name."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from bench_helpers import ROOT
from benchmark import harness

PROBE = r"""
import json, sys
sys.path.insert(0, ROOT)
from benchmark import harness, compare, control, convs, counts, data, trace
from benchmark.reference import bcp, nets, sliding
reg = harness.Registry(ROOT)
for name in reg.cells():
    cell = reg.cell(name)   # its driver and every metric reader
    nets.arch(cell.config["reference_net"])     # its architecture file
import bcp_tpu_torch.cli.train_la, bcp_tpu_torch.cli.test_la
import bcp_tpu_torch.train.trainer
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_loads_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c",
                        f"ROOT = {ROOT!r}\n" + PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "bcp_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["bcp_tpu_torch", "bcp_tpu_torch.ops.cc", "jaxtyping", "flaxen"]) \
        == []
    assert harness.forbidden_modules(
        ["bcp_tpu.ops.cc", "jaxlib.xla_client", "optax", "torch"]) == [
        "bcp_tpu", "jaxlib", "optax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(ROOT, "benchmark", "reference", "**",
                                   "*.py"), recursive=True)
    assert any(os.sep + "archs" + os.sep in f for f in files)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "bcp_tpu_torch",) + harness.FORBIDDEN, (path, mod)
