"""The port's wrapper script, ``python -m peng_motif_tpu_torch.shoot``:
twins of tests/test_scripts.py's shoot_peng cases (the reference CI smoke
test, .travis.yml:23), and the same MEME and JSON bytes as the reference
repository's ``scripts/shoot_peng.py`` on the same input (both run their
exact engine on the CPU, so the comparison is byte for byte)."""

import json
import os
import subprocess
import sys

import pytest

import conftest  # noqa: F401

from peng_motif_tpu_torch import shoot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FASTA = os.path.join(GOLDEN, "MafK_100seqs.fasta")


def _env_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _shoot(args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "peng_motif_tpu_torch.shoot"] + args,
        cwd=REPO, env=_env_cpu(), capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("engine", ["auto", "tpu"])
def test_shoot_smoke(tmp_path, engine):
    """Exit 0 of ``shoot MafK_100seqs.fasta -w 6 --no-scoring -o out``,
    on either engine."""
    out = tmp_path / "test.out"
    r = _shoot([FASTA, "-w", "6", "--no-scoring", "--silent", "-o", str(out),
                "-j", str(tmp_path / "test.json"), "--device", "cpu",
                "--engine", engine])
    assert r.returncode == 0, r.stderr
    assert r.stdout == ""
    content = out.read_text()
    assert content.startswith("MEME version 4")
    assert "zoops_score= nan" in content
    data = json.loads((tmp_path / "test.json").read_text())
    assert data["patterns"]
    assert all("zoops_score" in p for p in data["patterns"])


def test_shoot_same_bytes_as_reference_script(tmp_path):
    outs = {}
    for label, cmd in (
            ("ref", [os.path.join(REPO, "scripts", "shoot_peng.py")]),
            ("port", ["-m", "peng_motif_tpu_torch.shoot", "--device",
                      "cpu"])):
        meme, js = tmp_path / f"{label}.meme", tmp_path / f"{label}.json"
        r = subprocess.run(
            [sys.executable] + cmd + [FASTA, "-w", "6", "--no-scoring",
                                      "--silent", "-o", str(meme), "-j",
                                      str(js)],
            cwd=REPO, env=_env_cpu(), capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stderr
        outs[label] = (meme.read_bytes(), js.read_bytes())
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][1] == outs["ref"][1]


def test_shoot_requires_output_file():
    r = _shoot([FASTA], timeout=120)
    assert r.returncode == 1
    assert "did not define an output file" in r.stderr


def test_shoot_without_a_card_exits_with_the_engines_error(tmp_path):
    """``--device`` defaults to the card, as on the port's CLI; without
    one the engine's exit code comes through and nothing is written."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "o.meme"
    r = _shoot([FASTA, "-w", "6", "--no-scoring", "--silent", "-o",
                str(out)], timeout=120)
    assert r.returncode == 1 and not out.exists()
    assert "torch.cuda.is_available() is false" in r.stderr


def test_engine_argv_and_fdr_command_match_reference_script():
    """The flag list handed to the engine is the reference script's plus
    nothing (``--device``/``--engine`` are appended only for the
    in-process run), and the FDR command is the same."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_shoot_peng", os.path.join(REPO, "scripts",
                                             "shoot_peng.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    argv = [FASTA, "-o", "x.meme", "-w", "8", "--strand", "PLUS", "--no-em",
            "--no-merging", "--use-default-pwm", "--no-neighbor-filtering",
            "--background-sequences", FASTA, "-t", "5"]
    a = shoot.build_parser().parse_args(argv + ["--device", "cpu",
                                                "--engine", "exact"])
    b = ref.build_parser().parse_args(argv)
    assert a.device == "cpu" and a.engine == "exact"
    assert shoot.build_engine_argv(a, "o.tmp", "j.tmp") == \
        ref.build_engine_argv(b, "o.tmp", "j.tmp")
    assert shoot.build_fdr_command(a, FASTA, "o.tmp", "d") == \
        ref.build_fdr_command(b, FASTA, "o.tmp", "d")
    with pytest.raises(SystemExit):
        shoot.build_parser().parse_args(argv + ["--device", "tpu"])


def test_write_meme_and_json_match_reference_script(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_shoot_peng", os.path.join(REPO, "scripts",
                                             "shoot_peng.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    with open(os.path.join(GOLDEN, "mafk100_w8.json")) as f:
        data = json.load(f)
    for p in data["patterns"]:
        p["zoops_score"], p["occur"] = 0.5, 0.25
    for name, fn in (("meme", "write_meme"), ("json", "write_json")):
        got, want = tmp_path / f"got.{name}", tmp_path / f"want.{name}"
        getattr(shoot, fn)(data, str(got))
        getattr(ref, fn)(data, str(want))
        assert got.read_bytes() == want.read_bytes()


# -- python -m peng_motif_tpu_torch.pwm2iupac against scripts/pwm2iupac.py --

_GOLDEN_PWM = "".join(open(os.path.join(GOLDEN, "mafk_w8.meme")).readlines()
                      [9:22])
PWM_CASES = {
    # tests/test_scripts.py's inputs: A, S (C/G), N; and its bad row
    "asn": "0.97 0.01 0.01 0.01\n0.01 0.485 0.485 0.02\n0.25 0.25 0.25 "
           "0.25\n",
    "bad_row": "0.9 0.9 0.9 0.9\n",
    # the first motif of a golden MEME file, 13 rows
    "golden_mafk_w8": _GOLDEN_PWM,
    # one row nearest each IUPAC letter, in a tab-separated file
    "every_letter": "".join(
        "\t".join(str(x) for x in row) + "\n" for row in (
            (0.91, 0.03, 0.03, 0.03), (0.03, 0.91, 0.03, 0.03),
            (0.03, 0.03, 0.91, 0.03), (0.03, 0.03, 0.03, 0.91),
            (0.02, 0.48, 0.48, 0.02), (0.48, 0.02, 0.02, 0.48),
            (0.48, 0.02, 0.48, 0.02), (0.02, 0.48, 0.02, 0.48),
            (0.48, 0.48, 0.02, 0.02), (0.02, 0.02, 0.48, 0.48),
            (0.2, 0.3, 0.3, 0.2))),
    # an exact zero: log2(0) in the distance, the reference's own quirk
    "zero_cell": "1.0 0.0 0.0 0.0\n0.5 0.5 0.0 0.0\n",
    "three_columns": "0.5 0.25 0.25\n",
    "bad_after_good": "0.97 0.01 0.01 0.01\n0.5 0.5 0.5 0.5\n",
    "empty": "",
    "missing": None,        # no such file
}
# cases whose stderr names no file of either script (tracebacks and
# numpy's warnings do)
_SAME_STDERR = {"asn", "bad_row", "golden_mafk_w8", "every_letter",
                "three_columns", "bad_after_good", "empty", "no_argument"}


@pytest.mark.parametrize("case", sorted(PWM_CASES) + ["no_argument"])
def test_pwm2iupac_same_as_reference_script(case, tmp_path):
    """The port's pwm2iupac and the repository's script on the same PWM
    file: identical stdout and exit code (stderr too, where it names no
    file of either)."""
    if case == "no_argument":
        args = []
    else:
        path = tmp_path / f"{case}.pwm"
        if PWM_CASES[case] is not None:
            path.write_text(PWM_CASES[case])
        args = [str(path)]
    runs = {}
    for label, cmd in (
            ("ref", [os.path.join(REPO, "scripts", "pwm2iupac.py")]),
            ("port", ["-m", "peng_motif_tpu_torch.pwm2iupac"])):
        r = subprocess.run([sys.executable] + cmd + args, cwd=REPO,
                           env=_env_cpu(), capture_output=True, text=True,
                           timeout=120)
        runs[label] = r
    ref, port = runs["ref"], runs["port"]
    assert (port.returncode, port.stdout) == (ref.returncode, ref.stdout)
    if case in _SAME_STDERR:
        assert port.stderr == ref.stderr
    want_rc = {"bad_row": 1, "three_columns": 1, "bad_after_good": 1,
               "missing": 1, "no_argument": 2}.get(case, 0)
    assert ref.returncode == want_rc, ref.stderr
    if case == "asn":
        assert port.stdout == "ASN\n"
    if case == "every_letter":
        assert port.stdout == "ACGTSWRYMKN\n"
