"""The port installs whole: every sub-package of ``peng_motif_tpu_torch``
is listed in ``pyproject.toml``, the kernel and native sources travel as
package data, and the console script points at the port's CLI."""

import glob
import os
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "peng_motif_tpu_torch"


@pytest.fixture(scope="module")
def project():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def _subpackages():
    found = []
    for root, dirs, files in os.walk(os.path.join(REPO, PKG)):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        if "__init__.py" in files:
            found.append(os.path.relpath(root, REPO).replace(os.sep, "."))
    return sorted(found)


def test_every_subpackage_is_listed(project):
    listed = set(project["tool"]["setuptools"]["packages"])
    found = _subpackages()
    assert PKG + ".parallel" in found and PKG + ".ops" in found
    assert not [p for p in found if p not in listed]


def test_listed_packages_exist(project):
    for name in project["tool"]["setuptools"]["packages"]:
        assert os.path.isfile(
            os.path.join(REPO, *name.split("."), "__init__.py")), name


def test_kernel_sources_are_package_data(project):
    import fnmatch

    patterns = project["tool"]["setuptools"]["package-data"][PKG]
    sources = (glob.glob(os.path.join(REPO, PKG, "csrc", "*.cu"))
               + glob.glob(os.path.join(REPO, PKG, "csrc", "*.cpp")))
    assert len(sources) >= 2
    for src in sources:
        rel = os.path.relpath(src, os.path.join(REPO, PKG))
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), rel


def test_console_script_names_the_ports_cli(project):
    import importlib

    target = project["project"]["scripts"]["peng_motif_torch"]
    module, func = target.split(":")
    assert module == PKG + ".cli"
    assert callable(getattr(importlib.import_module(module), func))
