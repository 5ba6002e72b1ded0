"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: an AST scan, comparing
top-level module names whole (``peng_motif_tpu_torch`` begins with
``peng_motif_tpu`` and is not it)."""

from __future__ import annotations

import ast
import os

import pytest

from bench_port import run as R

BENCH = R.BENCH
JAX = {"jax", "jaxlib", "flax", "peng_motif_tpu"}


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for root, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_imports(path) & JAX


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_independent(path):
    assert not top_imports(path) & (JAX | {"peng_motif_tpu_torch",
                                           "bench_port"})


def test_names_compare_whole():
    assert R.forbidden_modules(["peng_motif_tpu_torch.cli", "numpy"]) == []
    assert R.forbidden_modules(["peng_motif_tpu.ops", "jaxlib.xla"]) == [
        "jaxlib", "peng_motif_tpu"]
    assert R.forbidden_modules(["jax_free", "flaxen"]) == []
