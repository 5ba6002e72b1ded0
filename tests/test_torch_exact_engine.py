"""The port's exact engine (``--engine exact``) and the device engine's
fallbacks into it, through the port's CLI on the CPU.

Tolerance: none.  The exact engine is held byte-identical to the
reference binary's golden files (MEME, JSON where the case checks it,
and stdout), as tests/test_e2e_parity.py holds the reference package;
the fallbacks end in an exact-engine run, so they are held the same
way.
"""

import json
import os

import pytest
import torch

from conftest import GOLDEN_DIR
from test_e2e_parity import CASES
from test_engine_tpu import FORCED_DEVICE_CASES
from test_torch_engine import EDGE_INPUTS

from peng_motif_tpu.cli import main as reference_main
from peng_motif_tpu_torch import engine, pipeline
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.ops import climb
from peng_motif_tpu_torch.pattern_tables import Strand


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def _expected_stdout(stem):
    """The golden log without its warning lines (the reference binary's
    stderr was merged into it), or None when the case has no log."""
    path = os.path.join(GOLDEN_DIR, f"{stem}.log")
    if not os.path.exists(path):
        return None
    with open(path) as g:
        lines = g.read().splitlines(keepends=True)
    return "".join(ln for ln in lines if not ln.startswith("Warning:"))


def _run_byte_identical(argv, stem, check_json, tmp_path, capsys):
    meme, js = tmp_path / "out.meme", tmp_path / "out.json"
    argv = argv + ["-o", str(meme)] + (["-j", str(js)] if check_json else [])
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert meme.read_bytes() == _golden(f"{stem}.meme"), stem
    if check_json:
        assert js.read_bytes() == _golden(f"{stem}.json"), stem
    want = _expected_stdout(stem)
    if want is not None:
        assert out == want, f"stdout differs for {stem}"


@pytest.mark.parametrize("stem,args,check_json", CASES,
                         ids=[c[0] for c in CASES])
def test_exact_engine_byte_identical(stem, args, check_json, tmp_path,
                                     capsys):
    argv = ([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
            + ["--engine", "exact", "--device", "cpu"])
    _run_byte_identical(argv, stem, check_json, tmp_path, capsys)
    assert engine.LAST_ENGINE_USED == "exact"


@pytest.mark.parametrize("stem,args", FORCED_DEVICE_CASES,
                         ids=[c[0] for c in FORCED_DEVICE_CASES])
def test_forced_device_count_byte_identical(stem, args, tmp_path, capsys,
                                            monkeypatch):
    """The batch device count (ops/counting.CountJob's device program,
    here on the CPU with the plain histogram) feeds the byte-exact
    downstream unchanged."""
    monkeypatch.setenv("PENG_COUNT_HOST_MAX_BASES", "0")
    argv = ([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
            + ["--engine", "exact", "--device", "cpu"])
    _run_byte_identical(argv, stem, True, tmp_path, capsys)


# -- the device engine's fallbacks ------------------------------------------

MAFK100_W8 = [os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
              "--device", "cpu", "--engine", "tpu"]


@pytest.mark.parametrize("bound", ["MAX_STEPS", "ACC_CAP"])
def test_climb_overflow_falls_back_to_exact(bound, tmp_path, capsys,
                                            monkeypatch):
    """A walk that outruns the climb's trace bounds ends in an exact
    run (the reference engine's fallback, engine_tpu.py:1141-1142), with
    the golden output and stdout."""
    monkeypatch.setattr(climb, bound, 1 if bound == "MAX_STEPS" else 0)
    _run_byte_identical(list(MAFK100_W8), "mafk100_w8", True, tmp_path,
                        capsys)
    assert engine.LAST_ENGINE_USED == "exact"


def test_ltot_past_int32_falls_back_to_exact(tmp_path, capsys, monkeypatch):
    """ltot >= 2**31 (the int32 table bound) ends in an exact run
    (engine_tpu.py:1028-1030); the count phase's ltot is patched, not a
    2-Gbase corpus counted."""
    real = engine._count_phase
    seen = []

    def count_phase(*a, **k):
        out = real(*a, **k)
        seen.append(out[1])
        return (out[0], 1 << 31) + tuple(out[2:])

    monkeypatch.setattr(engine, "_count_phase", count_phase)
    _run_byte_identical(list(MAFK100_W8), "mafk100_w8", True, tmp_path,
                        capsys)
    assert seen and engine.LAST_ENGINE_USED == "exact"


@pytest.mark.parametrize("name", ["empty_file", "header_only",
                                  "shorter_than_w"])
def test_degenerate_input_falls_back_to_exact(name, tmp_path, capsys):
    """Degenerate inputs (no sequence reaches W) under --engine tpu take
    the exact engine in both packages (engine_tpu.py:741-743): identical
    stdout and MEME."""
    fa = tmp_path / "in.fa"
    fa.write_text(EDGE_INPUTS[name])
    outs = {}
    for label, fn, extra in (("ref", reference_main, []),
                             ("port", main, ["--device", "cpu"])):
        meme = tmp_path / f"{label}.meme"
        assert fn([str(fa), "-w", "8", "--engine", "tpu", "-o", str(meme)]
                  + extra) == 0
        outs[label] = (capsys.readouterr().out, meme.read_text())
    assert outs["port"] == outs["ref"]
    assert engine.LAST_ENGINE_USED == "exact"


def test_device_engine_error_propagates(monkeypatch):
    """Only EngineFallback restarts on the exact engine: any other error
    of the device engine (here a RuntimeError from the stats program)
    reaches the caller."""
    def boom(*a, **k):
        raise RuntimeError("stats program failed")

    monkeypatch.setattr(engine, "stats_program", boom)
    monkeypatch.setattr(pipeline.Peng, "_process_exact", lambda *a: [])
    with pytest.raises(RuntimeError, match="stats program failed"):
        main(MAFK100_W8)
    assert engine.LAST_ENGINE_USED is None


@pytest.mark.parametrize("engine_flag,device,w,want", [
    ("auto", "cpu", 8, "exact"),
    ("auto", "cpu", 12, "exact"),
    ("auto", "cuda", 8, "tpu"),
    ("auto", "cuda", 12, "exact"),
    ("tpu", "cpu", 8, "tpu"),
    ("exact", "cuda", 8, "exact"),
])
def test_engine_resolution(engine_flag, device, w, want, monkeypatch):
    """--engine auto follows the reference's rule (pipeline.py:157-169)
    with "an accelerator is attached" read as a CUDA --device: the device
    engine below W 12 on cuda, the exact engine otherwise; tpu and exact
    are taken as given.  Both engines are stubbed: no card is needed."""
    from peng_motif_tpu_torch.io.fasta import load_sequence_set
    from peng_motif_tpu_torch.models.background import BackgroundModel

    chosen = []
    monkeypatch.setattr(pipeline, "process_gpu",
                        lambda peng, params: chosen.append("tpu") or [])
    monkeypatch.setattr(pipeline.Peng, "_process_exact",
                        lambda self, params: chosen.append("exact") or [])
    sset = load_sequence_set(os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"))
    peng = pipeline.Peng(Strand.BOTH_STRANDS, 2, 2, sset,
                         BackgroundModel(sset.sequences, order=2))
    params = pipeline.PengParameters(max_pattern_length=w,
                                     engine=engine_flag,
                                     device=torch.device(device))
    assert peng.process(params) == []
    assert chosen == [want]
    assert pipeline.resolve_engine(engine_flag, torch.device(device),
                                   w) == want


@pytest.mark.parametrize("engine_flag", ["tpu", "exact"])
def test_profile_writes_chrome_trace(engine_flag, tmp_path, capsys):
    """--profile wraps the run in torch.profiler and writes a Chrome
    trace (JSON with traceEvents) into the directory."""
    trace_dir = tmp_path / "trace"
    assert main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "8",
                 "--device", "cpu", "--engine", engine_flag, "--profile",
                 str(trace_dir), "-o", str(tmp_path / "o.meme")]) == 0
    capsys.readouterr()
    with open(trace_dir / "trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
