"""The port stands alone: with ``jax``, ``jaxlib`` and the reference
package ``peng_motif_tpu`` made unimportable, every module of
``peng_motif_tpu_torch`` imports and its CLI reproduces the golden
output (within the ENGINE_CASES tolerance of tests/test_engine_tpu.py).  Runs in a subprocess, so the test process's own imports do not
count."""

import os
import shutil
import subprocess
import sys

from conftest import GOLDEN_DIR
from test_torch_engine import _assert_within_tol, _read

REPO = os.path.dirname(os.path.dirname(GOLDEN_DIR))

_BLOCK = r'''
import importlib.abc
import sys

BLOCKED = ("jax", "jaxlib", "peng_motif_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None


sys.meta_path.insert(0, _Refuse())


def _check_clean():
    bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not bad, bad
'''


def _run(body, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _BLOCK + body, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    proc = _run(r'''
import pkgutil
import peng_motif_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
_check_clean()
print(len(names))
''')
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 31


def test_parallel_modules_import_without_jax():
    """The sharded and multi-process counts stand alone too: parallel/
    imports, a mesh run goes through, and torch.distributed is the only
    distribution layer loaded."""
    proc = _run(r'''
import numpy as np
from peng_motif_tpu_torch.parallel import dryrun, mesh, multihost, sharded
rng = np.random.default_rng(0)
codes = rng.integers(0, 5, size=(9, 40)).astype(np.uint8)
counts, ltot = sharded.count_patterns_sharded(
    codes, 4, True, mesh.make_data_mesh(4, "cpu"))
assert counts.sum() > 0 and ltot > 0
assert "torch.distributed" in sys.modules
_check_clean()
print("ok")
''')
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_cli_golden_without_jax(tmp_path):
    meme, js = str(tmp_path / "o.meme"), str(tmp_path / "o.json")
    proc = _run(r'''
from peng_motif_tpu_torch.cli import main
rc = main(sys.argv[1:])
_check_clean()
sys.exit(rc)
''', os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
        "--device", "cpu", "-o", meme, "-j", js)
    assert proc.returncode == 0, proc.stderr
    for got, stem in ((meme, "mafk100_w8.meme"), (js, "mafk100_w8.json")):
        _assert_within_tol(_read(got), _read(os.path.join(GOLDEN_DIR, stem)),
                           stem, 5e-6)


def test_native_source_is_the_ports_own():
    """The port builds its native library from a source inside its own
    package, a byte-for-byte copy of the reference package's (one source
    of truth for byte parity while both exist)."""
    from peng_motif_tpu_torch import native

    pkg = os.path.join(REPO, "peng_motif_tpu_torch")
    assert os.path.commonpath([native._SRC, pkg]) == pkg
    assert native._SRC == os.path.join(pkg, "csrc", "pengnative.cpp")
    ref = os.path.join(REPO, "peng_motif_tpu", "native", "pengnative.cpp")
    with open(native._SRC, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_no_module_names_the_reference_package_by_path():
    """No module of the port reaches into the reference package's
    directory (an import is refused above; a path would slip through)."""
    pkg = os.path.join(REPO, "peng_motif_tpu_torch")
    hits = []
    for root, _dirs, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for i, line in enumerate(f, 1):
                    if '"peng_motif_tpu"' in line or "'peng_motif_tpu'" in line:
                        hits.append(f"{name}:{i}")
    assert not hits, hits


def test_cli_golden_with_the_reference_package_absent(tmp_path):
    """A copy of the port alone, with no ``peng_motif_tpu/`` directory
    beside it, builds its native library and reproduces the golden
    output on the CPU."""
    shutil.copytree(
        os.path.join(REPO, "peng_motif_tpu_torch"),
        tmp_path / "peng_motif_tpu_torch",
        ignore=shutil.ignore_patterns("_build", "__pycache__"))
    fasta = tmp_path / "MafK_100seqs.fasta"
    shutil.copy(os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), fasta)
    assert not (tmp_path / "peng_motif_tpu").exists()
    meme, js = str(tmp_path / "o.meme"), str(tmp_path / "o.json")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK + r'''
import peng_motif_tpu_torch
from peng_motif_tpu_torch.cli import main
assert peng_motif_tpu_torch.__file__.startswith(sys.argv[1]), \
    peng_motif_tpu_torch.__file__
rc = main(sys.argv[2:])
_check_clean()
sys.exit(rc)
''', str(tmp_path), str(fasta), "-w", "8", "--device", "cpu", "--engine",
         "exact", "-o", meme, "-j", js],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "peng_motif_tpu_torch" / "_build"
            / "libpengnative.so").exists()
    for got, stem in ((meme, "mafk100_w8.meme"), (js, "mafk100_w8.json")):
        assert _read(got) == _read(os.path.join(GOLDEN_DIR, stem)), stem
    # the same from the copy over a mesh of two shards
    meme2 = str(tmp_path / "o2.meme")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK + r'''
from peng_motif_tpu_torch.cli import main
rc = main(sys.argv[1:])
_check_clean()
sys.exit(rc)
''', str(fasta), "-w", "8", "--device", "cpu", "--devices", "2", "--engine",
         "exact", "-o", meme2],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert _read(meme2) == _read(os.path.join(GOLDEN_DIR, "mafk100_w8.meme"))
