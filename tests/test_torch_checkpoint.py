"""Checkpoints and the BaMM background file: the port's format is the
reference package's, so either package resumes from the other's
checkpoint, with the reference binary's output.

Tolerance: none for the exact engine (byte-identical MEME and JSON);
the device engine's resumed runs are held to the ENGINE_CASES tolerance
of tests/test_engine_tpu.py (5e-6 absolute + 1e-6 relative).
"""

import contextlib
import io
import os

import numpy as np
import pytest

from conftest import GOLDEN_DIR
from test_torch_engine import _assert_within_tol, _read

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu.io.fasta import load_sequence_set as jload
from peng_motif_tpu.models.background import BackgroundModel as JBg
from peng_motif_tpu_torch import engine
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.io.fasta import load_sequence_set as tload
from peng_motif_tpu_torch.models.background import BackgroundModel as TBg
from peng_motif_tpu_torch.ops import counting

FASTA = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
STEM = "mafk100_w8"


def _models(order=2):
    return {"jax": JBg(jload(FASTA).sequences, order=order),
            "port": TBg(tload(FASTA).sequences, order=order)}


def _run(fn, argv, tmp_path, label):
    meme, js = tmp_path / f"{label}.meme", tmp_path / f"{label}.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = fn([FASTA, "-w", "8"] + argv + ["-o", str(meme), "-j", str(js)])
    assert rc == 0
    return meme.read_bytes(), js.read_bytes()


def _golden():
    with open(os.path.join(GOLDEN_DIR, f"{STEM}.meme"), "rb") as f, \
            open(os.path.join(GOLDEN_DIR, f"{STEM}.json"), "rb") as g:
        return f.read(), g.read()


# -- BaMM background files --------------------------------------------------


@pytest.mark.parametrize("order", [0, 2, 3])
def test_bamm_write_read_round_trip(order, tmp_path):
    bg = _models(order)["port"]
    bg.name = "m"
    path = bg.write(str(tmp_path))
    assert path.endswith("m.hbcp")
    back = TBg.read(path)
    assert back.order == order and back.interpolate and back.name == "m"
    np.testing.assert_array_equal(back.alpha, bg.alpha)
    for a, b in zip(back.v, bg.v):
        # written with 7 significant digits
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_bamm_files_cross_read(writer, reader, tmp_path):
    """Both packages write the same bytes, and a file written by one
    reads back in the other identically to the writer's own read."""
    models = _models()
    paths = {}
    for name, bg in models.items():
        (tmp_path / name).mkdir()
        paths[name] = bg.write(str(tmp_path / name))
    assert _read(paths["jax"]) == _read(paths["port"])
    cls = {"jax": JBg, "port": TBg}
    got, want = cls[reader].read(paths[writer]), cls[writer].read(
        paths[writer])
    assert got.order == want.order and got.name == want.name
    np.testing.assert_array_equal(got.alpha, want.alpha)
    for a, b in zip(got.v, want.v):
        np.testing.assert_array_equal(a, b)


# -- checkpoints --------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path, monkeypatch):
    """A checkpoint written by one package resumes byte-identically in
    the other's exact engine (and the port's resume runs no count)."""
    ckpt = str(tmp_path / "ckpt")
    if writer == "jax":
        _run(reference_main, ["--engine", "exact", "--save-checkpoint",
                              ckpt], tmp_path, "save")
    else:
        assert _run(main, ["--engine", "exact", "--device", "cpu",
                           "--save-checkpoint", ckpt], tmp_path,
                    "save") == _golden()
    assert sorted(os.listdir(ckpt)) == ["bg.hbcp", "checkpoint.json",
                                        "counts_w8_both_strands.npz"]
    if writer == "jax":
        def no_count(*a, **k):
            raise AssertionError("a resumed run counted the input")

        monkeypatch.setattr(counting, "CountJob", no_count)
        got = _run(main, ["--engine", "exact", "--device", "cpu",
                          "--load-checkpoint", ckpt], tmp_path, "load")
        assert engine.LAST_ENGINE_USED == "exact"
    else:
        got = _run(reference_main, ["--engine", "exact", "--load-checkpoint",
                                    ckpt], tmp_path, "load")
    assert got == _golden()


def test_device_engine_checkpoint_round_trip(tmp_path):
    """Saved by the device engine, loaded by the device engine (the
    table goes to the device with an empty fix-up: within tolerance) and
    by the exact engine (byte-identical)."""
    ckpt = str(tmp_path / "ckpt")
    dev = ["--device", "cpu", "--engine", "tpu"]
    saved = _run(main, dev + ["--save-checkpoint", ckpt], tmp_path, "save")
    assert engine.LAST_ENGINE_USED == "cpu"
    loaded = _run(main, dev + ["--load-checkpoint", ckpt], tmp_path, "load")
    assert engine.LAST_ENGINE_USED == "cpu"
    assert loaded == saved
    golden = _golden()
    for got, want in zip(loaded, golden):
        _assert_within_tol(got.decode(), want.decode(), STEM, 5e-6)
    exact = _run(main, ["--device", "cpu", "--engine", "exact",
                        "--load-checkpoint", ckpt], tmp_path, "exact")
    assert exact == golden


def test_reference_checkpoint_in_the_device_engine(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _run(reference_main, ["--engine", "exact", "--save-checkpoint", ckpt],
         tmp_path, "save")
    got = _run(main, ["--device", "cpu", "--engine", "tpu",
                      "--load-checkpoint", ckpt], tmp_path, "load")
    assert engine.LAST_ENGINE_USED == "cpu"
    for a, b in zip(got, _golden()):
        _assert_within_tol(a.decode(), b.decode(), STEM, 5e-6)


@pytest.mark.parametrize("engine_flag", ["exact", "tpu"])
def test_checkpoint_width_mismatch_exits_1(engine_flag, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    _run(main, ["--device", "cpu", "--engine", "exact", "--save-checkpoint",
                ckpt], tmp_path, "save")
    capsys.readouterr()
    rc = main([FASTA, "-w", "6", "--device", "cpu", "--engine", engine_flag,
               "--load-checkpoint", ckpt, "-o", str(tmp_path / "c.meme")])
    assert rc == 1
    assert "was written for -w 8" in capsys.readouterr().err
    assert not (tmp_path / "c.meme").exists()


def test_empty_checkpoint_dir_falls_back_to_exact(tmp_path):
    """No usable checkpoint under --engine tpu: the exact engine runs
    (engine_tpu.py:786-789), counts the input and gives the golden
    output."""
    empty = tmp_path / "empty"
    empty.mkdir()
    got = _run(main, ["--device", "cpu", "--engine", "tpu",
                      "--load-checkpoint", str(empty)], tmp_path, "load")
    assert engine.LAST_ENGINE_USED == "exact"
    assert got == _golden()
