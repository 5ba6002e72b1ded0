"""The port stands alone: with ``jax``, ``jaxlib`` and the reference
package ``peng_motif_tpu`` made unimportable, every module of
``peng_motif_tpu_torch`` imports and its CLI reproduces the golden
output (within the ENGINE_CASES tolerance of tests/test_engine_tpu.py).  Runs in a subprocess, so the test process's own imports do not
count."""

import os
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
    assert int(proc.stdout.split()[-1]) >= 26


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
