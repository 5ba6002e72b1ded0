"""The port's CLI end to end on the CPU (``--device cpu``): the golden
cases of the reference package's device engine (``--engine tpu``),
degenerate inputs against the reference CLI, and the port's own flag
errors.  The exact engine's cases are in tests/test_torch_exact_engine.py.  Every
golden case against the reference engine's output is in
tests/test_torch_engine_vs_jax.py.

Tolerance: the ENGINE_CASES contract of tests/test_engine_tpu.py —
structure and decisions identical, floats within 5e-6 absolute + 1e-6
relative (2e-5 for mafk_w8_rich).
"""

import os

import pytest
import torch

from conftest import GOLDEN_DIR
from test_engine_tpu import ENGINE_CASES

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu_torch import cli, engine
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.ops import histogram


def _read(path):
    with open(path) as f:
        return f.read()


def _assert_within_tol(got, want, stem, tol, rel=1e-6):
    got_lines, want_lines = got.splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines), f"line count differs: {stem}"
    for ln, (a, b) in enumerate(zip(got_lines, want_lines), 1):
        if a == b:
            continue
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), f"{stem}:{ln}: {a!r} vs {b!r}"
        for x, y in zip(ta, tb):
            if x == y:
                continue
            # JSON numbers carry their list brackets and commas
            px, py = x.strip("[],"), y.strip("[],")
            try:
                fx, fy = float(px), float(py)
            except ValueError:
                raise AssertionError(f"{stem}:{ln}: {a!r} vs {b!r}")
            assert x.replace(px, "") == y.replace(py, ""), \
                f"{stem}:{ln}: {a!r} vs {b!r}"
            assert abs(fx - fy) <= tol + rel * abs(fy), \
                f"{stem}:{ln}: {a!r} vs {b!r}"


@pytest.mark.parametrize("stem,args", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_cases_within_tolerance(stem, args, tmp_path):
    meme, js = str(tmp_path / "o.meme"), str(tmp_path / "o.json")
    argv = ([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
            + ["--device", "cpu", "--engine", "tpu", "-o", meme, "-j", js])
    assert main(argv) == 0
    tol = 2e-5 if stem == "mafk_w8_rich" else 5e-6
    _assert_within_tol(_read(meme), _read(
        os.path.join(GOLDEN_DIR, f"{stem}.meme")), stem, tol)
    golden_json = os.path.join(GOLDEN_DIR, f"{stem}.json")
    if os.path.exists(golden_json):
        _assert_within_tol(_read(js), _read(golden_json), stem, tol)
    assert engine.LAST_ENGINE_USED == "cpu"
    assert engine.LAST_CLIMB_ENGINE == engine.LAST_PWM_ENGINE == "device"


EDGE_INPUTS = {
    "empty_file": "",
    "header_only": ">only_header\n",
    "shorter_than_w": ">s1\nACGT\n",
    "all_n": ">s1\n" + "N" * 64 + "\n",
    "mixed_short_and_n": ">a\nACG\n>b\nNNNNACGTACGTNN\n>c\nTTGACTCA\n",
}


@pytest.mark.parametrize("name", list(EDGE_INPUTS))
def test_edge_inputs_match_reference_cli(name, tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_text(EDGE_INPUTS[name])
    outs = {}
    for label, fn, extra in (("ref", reference_main, []),
                             ("port", main, ["--device", "cpu"])):
        meme = tmp_path / f"{label}.meme"
        assert fn([str(fa), "-w", "8", "-o", str(meme)] + extra) == 0
        cap = capsys.readouterr()
        outs[label] = (cap.out, cap.err, meme.read_text())
    assert outs["port"][0] == outs["ref"][0]          # stdout
    assert outs["port"][2] == outs["ref"][2]          # MEME
    for ln in outs["ref"][1].splitlines():             # warnings
        if ln.startswith("Warning:"):
            assert ln in outs["port"][1]


def test_cpu_run_launches_no_kernel(tmp_path):
    before = histogram.LAUNCHES
    for eng in ("auto", "tpu"):
        assert main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"),
                     "-w", "8", "--device", "cpu", "--engine", eng,
                     "-o", str(tmp_path / "o.meme")]) == 0
        _assert_within_tol(_read(tmp_path / "o.meme"), _read(
            os.path.join(GOLDEN_DIR, "mafk100_w8.meme")), "mafk100_w8", 5e-6)
    assert histogram.LAUNCHES == before


def test_device_cuda_without_cuda_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "o.meme"
    rc = main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
               "--device", "cuda", "-o", str(out)])
    assert rc != 0
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
    assert not out.exists()


def test_default_device_is_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
               "-o", str(tmp_path / "o.meme")])
    assert rc != 0
    assert "--device cuda" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--devices", "2"], ["--num-processes", "2"], ["--process-id", "1"],
    ["--coordinator", "localhost:1234"]], ids=lambda f: f[0] + f[1])
def test_unported_flags_exit_with_error(flag, capsys):
    """The multi-device flags were refused until parallel/ was ported.
    Now each parses into the configuration (tests/test_torch_parallel.py
    and tests/test_torch_multihost.py run them); what still exits with an
    error is a flag without its value, and nothing says "not yet
    ported"."""
    fasta = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")
    cfg = cli.parse_args(["peng_motif", fasta, "-w", "8"] + flag)
    key = flag[0].lstrip("-").replace("-", "_")
    assert str(cfg[key]) == flag[1]
    with pytest.raises(SystemExit) as exc:
        main([fasta, "-w", "8", "--device", "cpu", flag[0]])
    assert exc.value.code == 4
    cap = capsys.readouterr()
    assert f"No expression following {flag[0]}" in cap.err
    assert "not yet ported" not in cap.err + cap.out + cli.HELP


def test_unknown_device_rejected(capsys):
    with pytest.raises(SystemExit) as exc:
        main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"),
              "--device", "tpu"])
    assert exc.value.code == 4
