"""The port's device engine (``--device cpu --engine tpu``) against the
reference package's device engine (``--engine tpu``, on the CPU) on every golden case of
tests/test_e2e_parity.py, from the same run, and on the two cases of the
reference's hardware parity list (tests_hw/test_hw_parity.py) that the
golden cases lack: MafK -w 10 and MafK_100seqs -w 12 (a 4**12 table:
about a minute on the CPU for the two engines together).

Tolerance: the ENGINE_CASES contract of tests/test_engine_tpu.py —
structure and decisions identical, floats within 5e-6 absolute + 1e-6
relative (2e-5 for mafk_w8_rich).  The MEME and, where the golden case
checks it, the JSON output are compared.

One case, synth_w8_emiter3, is accepted against either the reference
engine's output or the golden file: the reference engine merges it to a
different motif than the reference binary (ROADMAP Queue C), so the
port may agree with either; the test prints which (on the CPU it
agrees with the golden file).
"""

import os

import pytest

from conftest import GOLDEN_DIR
from test_e2e_parity import CASES
from test_torch_engine import _assert_within_tol, _read

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu_torch import engine
from peng_motif_tpu_torch.cli import main

EITHER_REFERENCE = {"synth_w8_emiter3"}

ALL_CASES = CASES + [
    ("mafk_w10", ["MafK.fasta", "-w", "10"], False),
    ("mafk100_w12", ["MafK_100seqs.fasta", "-w", "12"], False),
]


def _within_tol(got, want, stem, tol):
    try:
        _assert_within_tol(got, want, stem, tol)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("stem,args,check_json", ALL_CASES,
                         ids=[c[0] for c in ALL_CASES])
def test_port_matches_reference_engine(stem, args, check_json, tmp_path,
                                       capsys):
    outs = {}
    for label, fn, extra in (("ref", reference_main, ["--engine", "tpu"]),
                             ("port", main, ["--device", "cpu",
                                             "--engine", "tpu"])):
        meme, js = tmp_path / f"{label}.meme", tmp_path / f"{label}.json"
        argv = ([os.path.join(GOLDEN_DIR, args[0])] + args[1:] + extra
                + ["-o", str(meme), "-j", str(js)])
        assert fn(argv) == 0
        outs[label] = (meme.read_text(), js.read_text())
    capsys.readouterr()
    assert engine.LAST_CLIMB_ENGINE == engine.LAST_PWM_ENGINE == "device"
    tol = 2e-5 if stem == "mafk_w8_rich" else 5e-6
    wants = {"ref": outs["ref"]}
    if stem in EITHER_REFERENCE:
        wants["golden"] = (
            _read(os.path.join(GOLDEN_DIR, f"{stem}.meme")),
            _read(os.path.join(GOLDEN_DIR, f"{stem}.json")))
    agrees = [name for name, (meme, js) in wants.items()
              if _within_tol(outs["port"][0], meme, stem, tol)
              and (not check_json
                   or _within_tol(outs["port"][1], js, stem, tol))]
    # recorded in the test's captured output (pytest -rA shows it)
    print(f"{stem}: the port agrees with {', '.join(agrees) or 'neither'}")
    if stem not in EITHER_REFERENCE:
        # the full diff message on failure
        _assert_within_tol(outs["port"][0], outs["ref"][0], stem, tol)
        if check_json:
            _assert_within_tol(outs["port"][1], outs["ref"][1], stem, tol)
    assert agrees, f"{stem}: port matches neither the reference engine " \
        "nor the golden file"
