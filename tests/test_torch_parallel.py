"""The port's sharded counts (peng_motif_tpu_torch/parallel/) against
the reference package's, on the same numpy inputs made from a seed.

The reference side runs its ``shard_map`` programs on the virtual
8-device CPU mesh of tests/conftest.py (its Pallas histogram falls back
to the XLA scatter there, as in its own tests); the port runs on a mesh
of ``cpu`` entries, whose shards run in turn and whose histogram takes
the plain version.  Every quantity compared is an integer and must be
identical: count table, canonical slice, ltot, suspicion flags,
background counts.  The CLI cases hold ``--devices 8`` byte-identical to
the golden files on the exact engine and within the ENGINE_CASES
tolerance (5e-6 absolute + 1e-6 relative) on the device engine.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from conftest import GOLDEN_DIR
from test_engine_tpu import DEVICES_CASES
from test_torch_engine import _assert_within_tol, _read

from peng_motif_tpu.models import background as jbg
from peng_motif_tpu.ops import counting as jcnt
from peng_motif_tpu.ops import stream_count as jsc
from peng_motif_tpu.parallel import sharded as jsh
from peng_motif_tpu_torch import engine as teng
from peng_motif_tpu_torch.cli import main
from peng_motif_tpu_torch.models import background as tbg
from peng_motif_tpu_torch.ops import counting as tcnt
from peng_motif_tpu_torch.ops import histogram
from peng_motif_tpu_torch.ops import stream_count as tsc
from peng_motif_tpu_torch.parallel import sharded as tsh
from peng_motif_tpu_torch.parallel.dryrun import dryrun_multichip
from peng_motif_tpu_torch.parallel.mesh import make_data_mesh


def _jmesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("data",))


def _np(t):
    return t.cpu().numpy()


# -- the mesh -----------------------------------------------------------------


def test_make_data_mesh_cpu_is_n_virtual_shards():
    assert make_data_mesh(4, "cpu") == (torch.device("cpu"),) * 4
    assert make_data_mesh(None, torch.device("cpu")) == (torch.device("cpu"),)


def test_make_data_mesh_refuses_more_cards_than_there_are():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=(
            f"requested {n + 1} devices, only {n} available")):
        make_data_mesh(n + 1, "cuda")


@pytest.mark.parametrize("kind", ["cpu", "cuda"])
@pytest.mark.parametrize("n", [0, -2])
def test_make_data_mesh_refuses_fewer_than_one(n, kind):
    with pytest.raises(ValueError, match=f"requested {n} devices"):
        make_data_mesh(n, kind)


@pytest.mark.parametrize("flag,value", [
    ("--devices", "0"), ("--devices", "-1"), ("--devices", "two"),
    ("--num-processes", "0"), ("--process-id", "-1")])
def test_cli_rejects_bad_counts(flag, value, tmp_path, capsys):
    """A count that is no integer, or below its least value, ends the
    run with the parser's exit code; it is never read as 'no mesh'."""
    out = tmp_path / "o.meme"
    with pytest.raises(SystemExit) as e:
        main([os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta"), "-w", "6",
              "--device", "cpu", flag, value, "-o", str(out)])
    assert e.value.code == 4 and not out.exists()
    assert f"{flag} takes an integer" in capsys.readouterr().err


@pytest.mark.parametrize("m_pad,n", [(200_000, 2), (114_688, 1), (8192, 3),
                                     (65_536, 1), (262_144, 3)])
def test_shard_layout_matches_reference_rule(m_pad, n):
    """per = ceil(m_pad / n), slab-aligned above 65,536
    (peng_motif_tpu/parallel/sharded.py:228-234)."""
    lay = tsc.make_layout([100], 8)._replace(m_pad=m_pad)
    per, got = tsh.shard_layout(lay, n)
    want = -(-m_pad // n)
    if want > 65536:
        want = -(-want // 16384) * 16384
    assert per == want and got.m_pad == want * n


# -- the stream count over a mesh ---------------------------------------------


def _long_contig():
    """The corpus of tests/test_stream_count.py::
    test_long_contig_sharded_mesh: one contig split over the shards."""
    rng = np.random.default_rng(7)
    s = rng.integers(1, 5, size=60_000).astype(np.uint8)
    s[rng.random(60_000) < 0.01] = 0
    return [s]


def _uniform_clean():
    """N-free sequences of one length: the 2-bit wire."""
    rng = np.random.default_rng(11)
    return [rng.integers(1, 5, size=311).astype(np.uint8)
            for _ in range(150)]


def _ragged_with_ns():
    rng = np.random.default_rng(1)
    seqs = []
    for n in rng.integers(3, 700, size=60):
        s = rng.integers(1, 5, size=int(n)).astype(np.uint8)
        s[rng.random(int(n)) < 0.08] = 0
        seqs.append(s)
    return seqs


STREAM_CASES = {
    # corpus, mesh size, 2-bit wire expected
    "long_contig_mesh8": (_long_contig, 8, False),
    "uniform_wire2_mesh3": (_uniform_clean, 3, True),
    "uniform_wire2_mesh7": (_uniform_clean, 7, True),
    "ragged_ns_mesh5": (_ragged_with_ns, 5, False),
}


@pytest.mark.parametrize("bg_order", [-1, 2], ids=["nobg", "bg2"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_count_sharded_matches_reference(case, both, bg_order):
    make, n, wire2 = STREAM_CASES[case]
    seqs = make()
    W = 8
    flat = np.concatenate(seqs)
    j_counts, j_vals, j_max, j_ltot, j_susp, j_bg, j_stream, j_lay = \
        jsh.stream_count_sharded(seqs, W, both, _jmesh(n), flat_codes=flat,
                                 bg_order=bg_order)
    assert int(j_max) <= np.iinfo(np.uint16).max   # the u16 slice is whole
    stream, lay, out = tsh.stream_count_sharded(
        seqs, W, both, make_data_mesh(n, "cpu"), flat_codes=flat,
        bg_order=bg_order)
    counts, vals, ltot, susp, bg = out
    assert wire2 == tsc.wire2_eligible(lay, int((flat == 0).sum()))
    if n in (3, 5, 7):
        assert tsc.make_layout([len(s) for s in seqs], W).m_pad % n != 0
    assert lay.m_pad == j_lay.m_pad and lay.m_pad % n == 0
    np.testing.assert_array_equal(stream, j_stream)
    np.testing.assert_array_equal(_np(counts), np.asarray(j_counts))
    np.testing.assert_array_equal(_np(vals), np.asarray(j_vals))
    assert counts.dtype == vals.dtype == torch.int32
    assert int(ltot) == int(j_ltot)
    assert susp.shape == (lay.m_pad,)
    np.testing.assert_array_equal(_np(susp), np.asarray(j_susp))
    if bg_order < 0:
        assert bg is None and j_bg is None
    else:
        np.testing.assert_array_equal(_np(bg), np.asarray(j_bg))


@pytest.mark.parametrize("case", ["long_contig_mesh8", "uniform_wire2_mesh3"])
def test_stream_count_sharded_equals_single_device(case):
    """The mesh count against the single-device count (a mesh of one,
    whose layout is not padded): identical table, slice, ltot and background; suspicion equal on the real chunks and
    clear on the padding; and the exact table after the host fix-up."""
    make, n, _ = STREAM_CASES[case]
    seqs = make()
    W, both = 8, True
    flat = np.concatenate(seqs)
    n_undef = int((flat == 0).sum())
    _, lay1, out1 = tsh.stream_count_sharded(
        seqs, W, both, make_data_mesh(1, "cpu"), flat_codes=flat, bg_order=2,
        n_undefined=n_undef)
    assert lay1.m_pad == tsc.make_layout([len(s) for s in seqs], W).m_pad
    stream, lay, out = tsh.stream_count_sharded(
        seqs, W, both, make_data_mesh(n, "cpu"), flat_codes=flat, bg_order=2)
    for a, b in zip(out[:3] + out[4:], out1[:3] + out1[4:]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(out[3])[: lay1.m_pad],
                                  _np(out1[3]))
    assert not _np(out[3])[lay1.m_pad:].any()
    # susp indexes the padded global chunk axis: the fix-up takes it
    vals, ltot, susp, _ = teng._fetch(out)
    table = teng._mirror_host(vals, W, both)
    ids, dvs, ltot_delta = tsc.stream_fixup_pairs(stream, lay, susp, both)
    np.add.at(table, ids, dvs)
    want, want_ltot = jsc.StreamCountJob(seqs, W, both).finish()
    np.testing.assert_array_equal(table, want)
    assert ltot + ltot_delta == want_ltot


@pytest.mark.parametrize("wire", ["mask", "wire2"])
def test_stream_count_sharded_slab_aligned_shards(wire, monkeypatch):
    """Shards above the slab threshold (65,536 chunks at full size; the
    constants are made small here) are padded to whole slabs and counted
    by the slab loop: every integer equals the reference package's
    single-device count of the same corpus, which does not depend on the
    padding."""
    monkeypatch.setattr(tsc, "_SLAB", 8)
    monkeypatch.setattr(tsc, "_SLAB_MIN", 32)
    monkeypatch.setattr(tsh, "_SLAB", 8)
    monkeypatch.setattr(tsh, "_SLAB_MIN", 32)
    seqs = _uniform_clean() if wire == "wire2" else _ragged_with_ns() * 2
    W, both, n = 8, True, 3
    flat = np.concatenate(seqs)
    stream, lay, out = tsh.stream_count_sharded(
        seqs, W, both, make_data_mesh(n, "cpu"), flat_codes=flat, bg_order=2)
    per = lay.m_pad // n
    assert per > 32 and per % 8 == 0
    assert per != -(-tsc.make_layout([len(s) for s in seqs], W).m_pad // n)
    j_stream, j_lay = jsc.build_stream(seqs, W, flat_codes=flat)
    wire2 = jsc.wire2_eligible(j_lay, int((flat == 0).sum()))
    assert wire2 == (wire == "wire2")
    if wire2:
        meta = jnp.asarray([int(j_lay.lengths[0]), j_lay.stream_len],
                           jnp.int32)
        j_counts, blob = jsc.stream_count_device_fused2(
            jnp.asarray(jsc.chunked_packed2(j_stream, j_lay)), meta,
            j_lay.row, j_lay.ctx, W, both, 2)
    else:
        j_counts, blob = jsc.stream_count_device_fused(
            jnp.asarray(jsc.chunked_packed(j_stream, j_lay)), j_lay.row,
            j_lay.ctx, W, both, 2)
    j_ltot, _max, j_susp, j_vals, j_bg = jsc.split_fetch_blob(
        np.asarray(blob), j_lay.m_pad, jcnt._n_canonical(W), 2)
    counts, vals, ltot, susp, bg = out
    np.testing.assert_array_equal(_np(counts), np.asarray(j_counts))
    np.testing.assert_array_equal(_np(vals), j_vals.astype(np.int32))
    assert int(ltot) == j_ltot
    np.testing.assert_array_equal(_np(bg), j_bg)
    np.testing.assert_array_equal(_np(susp)[: j_lay.m], j_susp[: j_lay.m])
    assert not _np(susp)[j_lay.m:].any()


def test_shard_base_gives_global_chunk_indices():
    """The 2-bit wire's validity rule needs the global chunk index: two
    halves counted with their ``base`` add up to the whole, and the
    second half counted from 0 does not."""
    seqs = _uniform_clean()
    W = 8
    stream, lay = tsc.build_stream(seqs, W)
    buf = torch.from_numpy(tsc.chunked_packed2(stream, lay)).view(
        lay.m_pad, -1)
    meta = (int(lay.lengths[0]), int(lay.stream_len))
    whole = tsc.stream_shard_counts(buf, meta, lay.row, lay.ctx, W, True, 2)
    half = lay.m_pad // 2
    a = tsc.stream_shard_counts(buf[:half], meta, lay.row, lay.ctx, W, True,
                                2)
    b = tsc.stream_shard_counts(buf[half:], meta, lay.row, lay.ctx, W, True,
                                2, base=half)
    assert torch.equal(a[0] + b[0], whole[0])
    assert int(a[1] + b[1]) == int(whole[1])
    assert torch.equal(torch.cat([a[2], b[2]]), whole[2])
    assert torch.equal(a[3] + b[3], whole[3])
    wrong = tsc.stream_shard_counts(buf[half:], meta, lay.row, lay.ctx, W,
                                    True, 2)
    assert not torch.equal(a[0] + wrong[0], whole[0])


# -- the batch count over a mesh ----------------------------------------------


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("W", [4, 6])
def test_count_patterns_sharded_matches_reference(W, both):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 5, size=(21, 40)).astype(np.uint8)  # odd batch
    j_counts, j_ltot = jsh.count_patterns_sharded(codes, W, both, _jmesh(8))
    counts, ltot = tsh.count_patterns_sharded(
        codes, W, both, make_data_mesh(8, "cpu"))
    assert counts.dtype == np.int32
    np.testing.assert_array_equal(counts, np.asarray(j_counts))
    assert ltot == int(j_ltot)
    single, single_ltot = tcnt.count_patterns(codes, W, both)
    np.testing.assert_array_equal(counts, _np(single))
    assert ltot == single_ltot


def test_count_patterns_sharded_fixes_up_suspicious_rows():
    """Tandem repeats (same-pattern chains with gaps < W) in rows of
    several shards: the host fix-up of the suspicious rows gives the
    reference's table."""
    rng = np.random.default_rng(3)
    codes = rng.integers(1, 5, size=(13, 64)).astype(np.uint8)
    codes[::3, 8:40] = np.tile(np.array([1, 2, 1, 2], dtype=np.uint8), 8)
    codes[5, :32] = 1
    W, both = 6, True
    j_counts, j_ltot = jsh.count_patterns_sharded(codes, W, both, _jmesh(4))
    counts, ltot = tsh.count_patterns_sharded(
        codes, W, both, make_data_mesh(4, "cpu"))
    np.testing.assert_array_equal(counts, np.asarray(j_counts))
    assert ltot == int(j_ltot)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_count_device_full_sharded_matches_reference(both):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 5, size=(21, 40)).astype(np.uint8)
    W = 6
    j_counts, j_vals, j_max, j_ltot, j_susp, j_codes = \
        jsh.count_device_full_sharded(codes, W, both, _jmesh(8))
    assert int(j_max) <= np.iinfo(np.uint16).max
    counts, vals, ltot, susp, padded = tsh.count_device_full_sharded(
        codes, W, both, make_data_mesh(8, "cpu"))
    np.testing.assert_array_equal(_np(counts), np.asarray(j_counts))
    np.testing.assert_array_equal(_np(vals), np.asarray(j_vals))
    assert int(ltot) == int(j_ltot)
    np.testing.assert_array_equal(_np(susp), np.asarray(j_susp))
    np.testing.assert_array_equal(padded, j_codes)


@pytest.mark.parametrize("shape", [(0, 40), (5, 3)], ids=["no_rows", "short"])
def test_count_patterns_sharded_degenerate_batch(shape):
    counts, ltot = tsh.count_patterns_sharded(
        np.zeros(shape, dtype=np.uint8), 4, True, make_data_mesh(2, "cpu"))
    assert counts.shape == (4 ** 4,) and not counts.any() and ltot == 0


# -- background counts over a mesh --------------------------------------------


def _bg_batch(with_ns):
    rng = np.random.default_rng(8)
    seqs = [rng.integers(1, 5, size=rng.integers(5, 30)).astype(np.uint8)
            for _ in range(13)]
    if with_ns:
        for s in seqs[::2]:
            s[rng.integers(0, len(s), size=2)] = 0
        seqs[1][-3:] = 0                       # trailing Ns: y == 0 windows
        seqs[3][:] = 1                         # all-A
        seqs[3][4] = 0                         # the signed-modulo rescue
    codes = np.zeros((len(seqs), max(len(s) for s in seqs)), dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = s
    return seqs, codes, np.array([len(s) for s in seqs], dtype=np.int32)


@pytest.mark.parametrize("with_ns", [False, True], ids=["clean", "ns"])
def test_count_bg_kmers_sharded_matches_reference(with_ns):
    seqs, codes, lengths = _bg_batch(with_ns)
    want = jsh.count_bg_kmers_sharded(codes, 2, _jmesh(4), lengths=lengths)
    got = tsh.count_bg_kmers_sharded(codes, 2, make_data_mesh(4, "cpu"),
                                     lengths=lengths)
    host = jbg.count_kmers(seqs, 2)
    port_host = tbg.count_kmers(seqs, 2)
    for k in range(3):
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], host[k])
        np.testing.assert_array_equal(got[k], port_host[k])


@pytest.mark.parametrize("k", [0, 1, 3])
def test_bg_window_values_match_reference(k):
    _, codes, _ = _bg_batch(True)
    v, ok = tsh._bg_window_values(torch.from_numpy(codes), k)
    j_v, j_ok = jsh._bg_window_values(jnp.asarray(codes), k)
    np.testing.assert_array_equal(_np(ok), np.asarray(j_ok))
    np.testing.assert_array_equal(_np(v), np.asarray(j_v))


# -- the slice as a whole -----------------------------------------------------


def test_dryrun_multichip_cpu():
    dryrun_multichip(4, "cpu")


@pytest.mark.parametrize("stem,args", DEVICES_CASES,
                         ids=[c[0] for c in DEVICES_CASES])
def test_devices_exact_engine_byte_identical(stem, args, tmp_path):
    """--devices 8 on the exact engine: sharded batch count and sharded
    background counts, then the native phases — the golden bytes."""
    meme, js = str(tmp_path / "o.meme"), str(tmp_path / "o.json")
    before = histogram.LAUNCHES
    assert main([os.path.join(GOLDEN_DIR, args[0])] + args[1:]
                + ["--devices", "8", "--device", "cpu", "--engine", "exact",
                   "-o", meme, "-j", js]) == 0
    assert teng.LAST_ENGINE_USED == "exact"
    assert histogram.LAUNCHES == before      # CPU tensors: the plain version
    assert _read(meme) == _read(os.path.join(GOLDEN_DIR, f"{stem}.meme"))
    golden_json = os.path.join(GOLDEN_DIR, f"{stem}.json")
    if os.path.exists(golden_json):
        assert _read(js) == _read(golden_json)


@pytest.mark.parametrize("stem,args", DEVICES_CASES,
                         ids=[c[0] for c in DEVICES_CASES])
def test_devices_device_engine_within_tolerance(stem, args, tmp_path):
    """--devices 8 --engine tpu: the sharded stream count with the fused
    background sum, then the device programs; and byte-identical to the
    same engine without --devices."""
    outs = {}
    for label, extra in (("mesh", ["--devices", "8"]), ("single", [])):
        meme = str(tmp_path / f"{label}.meme")
        assert main([os.path.join(GOLDEN_DIR, args[0])] + args[1:] + extra
                    + ["--device", "cpu", "--engine", "tpu", "-o", meme]) == 0
        assert teng.LAST_ENGINE_USED == "cpu"
        outs[label] = _read(meme)
    _assert_within_tol(outs["mesh"], _read(
        os.path.join(GOLDEN_DIR, f"{stem}.meme")), stem, 5e-6)
    assert outs["mesh"] == outs["single"]
