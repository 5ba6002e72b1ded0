"""The port's stream count (peng_motif_tpu_torch/ops/stream_count.py and
the pieces under it) against the reference package's JAX programs.

Both packages get the same numpy inputs, made from a seed: the same
corpora as tests/test_stream_count.py, and the exact wire buffer the
reference's count program takes.  The port runs on CPU tensors, so its histogram takes the plain version.  Counts,
ltot, suspicion flags and background counts must be bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peng_motif_tpu.models import background as jbg
from peng_motif_tpu.ops import counting as jcnt
from peng_motif_tpu.ops import encoding as jenc
from peng_motif_tpu.ops import stream_count as jsc
from peng_motif_tpu_torch import engine as teng
from peng_motif_tpu_torch.models import background as tbg
from peng_motif_tpu_torch.ops import counting as tcnt
from peng_motif_tpu_torch.ops import encoding as tenc
from peng_motif_tpu_torch.ops import stream_count as tsc
from peng_motif_tpu_torch.parallel import sharded as tsh

CPU1 = (torch.device("cpu"),)   # the single-device count: a mesh of one

ROW = jsc.ROW


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.cpu().numpy()


# -- corpora (those of tests/test_stream_count.py) ---------------------------


def _ragged_random():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 5, size=int(n)).astype(np.uint8)
            for n in rng.integers(3, 900, size=40)], 8


def _ragged_with_ns():
    rng = np.random.default_rng(1)
    seqs = []
    for n in rng.integers(3, 700, size=30):
        s = rng.integers(1, 5, size=int(n)).astype(np.uint8)
        s[rng.random(int(n)) < 0.08] = 0
        seqs.append(s)
    return seqs, 6


def _tandem_repeats():
    return [np.tile(np.array([1, 4], dtype=np.uint8), 3 * ROW),
            np.tile(np.array([1, 2, 3], dtype=np.uint8), ROW)], 6


def _long_contig():
    rng = np.random.default_rng(2)
    s = rng.integers(1, 5, size=200_000).astype(np.uint8)
    s[rng.random(200_000) < 0.01] = 0
    s[5_000:5_200] = np.tile(np.array([2, 2, 1, 2], dtype=np.uint8), 50)
    return [s], 8


def _seam_parity_chain():
    W = 6
    rng = np.random.default_rng(3)
    s = rng.integers(1, 5, size=4 * ROW).astype(np.uint8)
    s[W :: W + 1] = 0
    return [s], W


def _sequence_boundaries():
    rng = np.random.default_rng(4)
    return [rng.integers(1, 5, size=int(n)).astype(np.uint8)
            for n in rng.integers(6, 40, size=200)], 6


def _short_and_degenerate():
    return [np.array([1, 2, 3], dtype=np.uint8),
            np.array([], dtype=np.uint8),
            np.array([1, 2, 3, 4, 1, 2, 3, 4], dtype=np.uint8)], 8


CORPORA = {
    "ragged_random": _ragged_random,
    "ragged_with_ns": _ragged_with_ns,
    "tandem_repeats": _tandem_repeats,
    "long_contig": _long_contig,
    "seam_parity_chain": _seam_parity_chain,
    "sequence_boundaries": _sequence_boundaries,
    "short_and_degenerate": _short_and_degenerate,
}


def _wire2_variant(seqs, W):
    """The corpus cut to the 2-bit wire's domain: sequences of one
    length (the median, at least W) with every N replaced by a base."""
    L = max(W, int(np.median([len(s) for s in seqs])))
    out = []
    for s in seqs:
        if len(s) >= L:
            s = s[:L].copy()
            fill = (1 + np.arange(L) % 4).astype(np.uint8)
            out.append(np.where(s == 0, fill, s))
    return out


def _reference_fused(buf_np, lay, W, both, bg_order, wire2):
    """The reference package's fused count on the same wire bytes."""
    buf = jnp.asarray(buf_np)
    if wire2:
        meta = jnp.asarray([int(lay.lengths[0]), lay.stream_len], jnp.int32)
        counts, blob = jsc.stream_count_device_fused2(
            buf, meta, lay.row, lay.ctx, W, both, bg_order)
    else:
        counts, blob = jsc.stream_count_device_fused(
            buf, lay.row, lay.ctx, W, both, bg_order)
    n_canon = jcnt._n_canonical(W) if both else 4 ** W
    ltot, max_c, susp, vals, bg = jsc.split_fetch_blob(
        np.asarray(blob), lay.m_pad, n_canon, bg_order)
    assert max_c <= np.iinfo(np.uint16).max  # u16 blob holds every count
    return np.asarray(counts), vals.astype(np.int32), ltot, susp, bg


def _port_buffer(buf_np, lay, wire2):
    """The reference's wire buffer as the port's count takes it: (buf
    [m_pad, row bytes] uint8, meta)."""
    nb = tsc.row_nbytes2(lay.row) if wire2 else tsc.row_nbytes(lay.row)
    meta = (int(lay.lengths[0]), int(lay.stream_len)) if wire2 else None
    return torch.from_numpy(buf_np).view(-1, nb), meta


def _port_fused(buf_np, lay, W, both, bg_order, wire2):
    buf, meta = _port_buffer(buf_np, lay, wire2)
    counts, ltot, susp, bg = tsc.stream_shard_counts(
        buf, meta, lay.row, lay.ctx, W, both, bg_order)
    counts, vals = tsc.stream_compact(counts, W, both)
    assert counts.dtype == torch.int32 and vals.dtype == torch.int32
    assert vals.shape == (tcnt._n_canonical(W) if both else 4 ** W,)
    return (_np(counts), _np(vals), int(ltot), _np(susp),
            None if bg is None else _np(bg))


def _assert_same(got, want):
    counts, vals, ltot, susp, bg = got
    w_counts, w_vals, w_ltot, w_susp, w_bg = want
    np.testing.assert_array_equal(counts, w_counts)
    np.testing.assert_array_equal(vals, w_vals)
    assert ltot == w_ltot
    np.testing.assert_array_equal(susp, w_susp)
    if w_bg is None:
        assert bg is None
    else:
        np.testing.assert_array_equal(bg, w_bg)


@pytest.mark.parametrize("wire", ["mask", "wire2"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_fused_count_matches_reference(corpus, both, wire):
    seqs, W = CORPORA[corpus]()
    wire2 = wire == "wire2"
    if wire2:
        seqs = _wire2_variant(seqs, W)
    stream, lay = jsc.build_stream(seqs, W)
    if wire2:
        assert jsc.wire2_eligible(lay, 0)
        buf_np = jsc.chunked_packed2(stream, lay)
    else:
        buf_np = jsc.chunked_packed(stream, lay)
    bg_order = 2 if both else -1
    _assert_same(_port_fused(buf_np, lay, W, both, bg_order, wire2),
                 _reference_fused(buf_np, lay, W, both, bg_order, wire2))


@pytest.mark.parametrize("wire", ["mask", "wire2"])
@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_slab_loop_matches_reference(both, wire, monkeypatch):
    """The slab loop (chunk counts above _SLAB_MIN) against the
    reference's un-jitted fori_loop, with the slab made small in both
    packages, and against the port's own single pass."""
    rng = np.random.default_rng(17)
    W, slab = 8, 32
    wire2 = wire == "wire2"
    if wire2:
        seqs = [rng.integers(1, 5, size=311).astype(np.uint8)
                for _ in range(60)]
    else:
        seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
                for n in rng.integers(3, 2000, size=40)]
    stream, lay = jsc.build_stream(seqs, W, row=128)
    lay = lay._replace(m_pad=-(-lay.m_pad // slab) * slab)
    buf_np = (jsc.chunked_packed2 if wire2 else jsc.chunked_packed)(
        stream, lay)
    bg_order = 2
    core = lay.row - W + 1 - lay.ctx
    buf, meta = _port_buffer(buf_np, lay, wire2)
    jbuf = jnp.asarray(buf_np).reshape(buf.shape)

    jcodes_fn = tcodes_fn = None
    if wire2:
        seq_len, stream_len = meta
        j_meta = (jnp.int32(seq_len), jnp.int32(stream_len))

        def jcodes_fn(sl, g0):
            return jsc._unpack_codes2(sl, lay.row, g0, core, lay.ctx, W,
                                      *j_meta)

        def tcodes_fn(sl, g0):
            return tsc._unpack_codes2(sl, lay.row, g0, core, lay.ctx, W,
                                      seq_len, stream_len)

    single = tsc._accumulated_local_counts(
        buf, lay.row, lay.ctx, W, both, bg_order, codes_fn=tcodes_fn)
    for mod in (jsc, tsc):
        monkeypatch.setattr(mod, "_SLAB", slab)
        monkeypatch.setattr(mod, "_SLAB_MIN", slab)
    got = tsc._accumulated_local_counts(
        buf, lay.row, lay.ctx, W, both, bg_order, codes_fn=tcodes_fn)
    want = jsc._accumulated_local_counts(
        jbuf, lay.row, lay.ctx, W, both, bg_order, codes_fn=jcodes_fn)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(_np(g), _np(s))


# -- unit level ----------------------------------------------------------------


@pytest.mark.parametrize("W", [4, 5, 8])
def test_id_tables_match_reference(W):
    np.testing.assert_array_equal(_np(tenc.rc_ids_flat(W, "cpu")),
                                  np.asarray(jenc.rc_ids_flat(W)))
    np.testing.assert_array_equal(_np(tenc.canonical_mask_flat(W, "cpu")),
                                  jcnt._np_canonical_mask_flat(W))
    idx = _np(tenc.canonical_idx_flat(W, "cpu"))
    np.testing.assert_array_equal(idx, np.asarray(jenc.canonical_idx_flat(W)))
    assert idx.shape == (tcnt._n_canonical(W),)


def _codes(b, length, seed, n_frac=0.1):
    rng = np.random.default_rng(seed)
    c = rng.integers(1, 5, size=(b, length)).astype(np.uint8)
    c[rng.random((b, length)) < n_frac] = 0
    return c


@pytest.mark.parametrize("W", [4, 8, 12])
def test_window_ids(W):
    codes = _codes(6, 300, seed=W)
    got = tenc.window_ids(_t(codes), W)
    want = jenc.window_ids(jnp.asarray(codes), W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("W", [3, 6, 10])
def test_naive_dedup(W):
    rng = np.random.default_rng(W)
    # a 3-id alphabet plus invalid windows: dense same-id chains
    cids = rng.integers(-1, 3, size=(8, 200)).astype(np.int32)
    got = tcnt.naive_dedup(_t(cids), W)
    want = jcnt.naive_dedup(jnp.asarray(cids), W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("case", ["random_ns", "parity_chain", "short_row"])
def test_skip_and_ambiguity(case):
    W = 6
    if case == "random_ns":
        codes = _codes(16, 512, seed=5, n_frac=0.15)
    elif case == "parity_chain":
        codes = _codes(8, 512, seed=6, n_frac=0.0)
        codes[:, W :: W + 1] = 0
        codes[1::2, :3] = 0
    else:
        codes = _codes(4, W + 3, seed=7)
    valid = jenc.window_ids(jnp.asarray(codes), W)[2]
    got = tsc._skip_and_ambiguity(_t(codes), _t(np.asarray(valid)), W)
    want = jsc._skip_and_ambiguity(jnp.asarray(codes), valid, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("length", [512, 301])
def test_unpack_codes(length):
    codes = _codes(12, length, seed=length)
    packed = jcnt.pack_codes(codes)
    np.testing.assert_array_equal(packed, tcnt.pack_codes(codes))
    got = tcnt._unpack_codes(_t(packed), length)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jcnt._unpack_codes(jnp.asarray(packed), length)))
    np.testing.assert_array_equal(_np(got), codes)


@pytest.mark.parametrize("g0", [0, 37])
def test_unpack_codes2(g0):
    rng = np.random.default_rng(g0)
    row, W = 128, 8
    ctx = 2 * (W - 1)
    core = row - W + 1 - ctx
    buf = rng.integers(0, 256, size=(24, jsc.row_nbytes2(row))).astype(
        np.uint8)
    seq_len, stream_len = 173, 5000
    got = tsc._unpack_codes2(_t(buf), row, g0, core, ctx, W, seq_len,
                             stream_len)
    want = jsc._unpack_codes2(jnp.asarray(buf), row, jnp.int32(g0), core,
                              ctx, W, jnp.int32(seq_len),
                              jnp.int32(stream_len))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("bg_order", [0, 1, 2, 3])
def test_stream_bg_counts(bg_order):
    codes = _codes(20, 128, seed=bg_order, n_frac=0.05)
    ctx, W = 14, 8
    core = 128 - W + 1 - ctx
    got = tsc.stream_bg_counts(_t(codes.astype(np.int32)), ctx, core,
                               bg_order)
    want = jsc.stream_bg_counts(jnp.asarray(codes.astype(np.int32)), ctx,
                                core, bg_order)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("W", [6, 8, 10])
def test_device_bg_plus_corrections_match_reference_scan(W):
    """Fused device background + host corrections == the reference
    package's count_kmers, on the N quirks of the background rule."""
    rng = np.random.default_rng(W)
    seqs = []
    for _ in range(25):
        s = rng.integers(1, 5, size=120).astype(np.uint8)
        s[rng.integers(0, 120, size=4)] = 0
        seqs.append(s)
    seqs += [np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1], np.uint8),
             np.array([1] * 20 + [0] + [1] * 20, np.uint8),
             np.array([2], np.uint8), np.array([0], np.uint8),
             rng.integers(1, 5, size=3000).astype(np.uint8)]
    K = 3 if W == 10 else 2
    stream, lay, out = tsh.stream_count_sharded(seqs, W, True, CPU1,
                                                bg_order=K)
    bg = _np(out[4]).astype(np.int64)
    corr = tbg.bg_device_corrections(seqs, K, lengths=lay.lengths)
    want = jbg.count_kmers(seqs, K)
    for k in range(K + 1):
        got = bg[tsc.bg_offset(k) : tsc.bg_offset(k) + 4 ** (k + 1)] + corr[k]
        np.testing.assert_array_equal(got, want[k], err_msg=f"order {k}")
    np.testing.assert_array_equal(tbg.count_kmers(seqs, K)[K], want[K])


# -- host parts -------------------------------------------------------------------


def test_layout_and_packing_match_reference():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 5, size=int(n)).astype(np.uint8)
            for n in rng.integers(3, 3000, size=30)]
    flat = np.concatenate(seqs)
    j_stream, j_lay = jsc.build_stream(seqs, 8, row=128)
    stream, lay = tsc.build_stream(seqs, 8, flat_codes=flat, row=128)
    np.testing.assert_array_equal(stream, j_stream)
    for a, b in zip(lay, j_lay):
        np.testing.assert_array_equal(a, b)
    packed = tsc.chunked_packed(stream, lay)
    np.testing.assert_array_equal(packed, jsc.chunked_packed(stream, lay))
    np.testing.assert_array_equal(
        packed, tcnt.pack_codes(tsc.chunk_rows(stream, lay)).reshape(-1))
    np.testing.assert_array_equal(tsc.chunked_packed2(stream, lay),
                                  jsc.chunked_packed2(stream, lay))


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
def test_fixup_matches_reference(both):
    """Every chunk suspicious on a repeat/N-heavy stream: the native
    fix-up equals the reference's, and its Python twin."""
    rng = np.random.default_rng(11)
    W = 8
    seqs = []
    for n in rng.integers(3, 2000, size=25):
        s = rng.integers(1, 5, size=int(n)).astype(np.uint8)
        s[rng.random(int(n)) < 0.05] = 0
        if int(n) > 40:
            unit = rng.integers(1, 5, size=4).astype(np.uint8)
            p = int(rng.integers(0, int(n) - 36))
            s[p : p + 36] = np.tile(unit, 9)
        seqs.append(s)
    stream, lay = tsc.build_stream(seqs, W, row=128)
    susp = np.ones(lay.m_pad, dtype=bool)
    got = tsc.stream_fixup_pairs(stream, lay, susp, both)
    want = jsc.stream_fixup_pairs(stream, lay, susp, both)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    delta, ltot_delta = tsc.stream_fixup_delta(stream, lay, susp, both)
    assert (delta, ltot_delta) == jsc.stream_fixup_delta(
        stream, lay, susp, both)
    assert ltot_delta == got[2]


@pytest.mark.parametrize("corpus", ["ragged_with_ns", "tandem_repeats",
                                    "seam_parity_chain"])
def test_count_with_fixup_matches_reference_scan(corpus):
    """Device count + host mirror + fix-up (the engine's count phase)
    equals the transcription of the reference's rolling scan."""
    seqs, W = CORPORA[corpus]()
    for both in (True, False):
        stream, lay, out = tsh.stream_count_sharded(seqs, W, both, CPU1)
        vals, ltot, susp, _ = teng._fetch(out)
        counts = teng._mirror_host(vals, W, both)
        ids, dvs, ltot_delta = tsc.stream_fixup_pairs(stream, lay, susp, both)
        np.add.at(counts, ids, dvs)
        want = np.zeros(4 ** W, dtype=np.int64)
        want_ltot = 0
        for s in seqs:
            c, lt = tcnt.reference_scan_row(s, W, both)
            want_ltot += lt
            for k, v in c.items():
                want[k] += v
                rk = tcnt._np_revcomp_id(k, W)
                if both and rk != k:
                    want[rk] += v
        assert ltot + ltot_delta == want_ltot
        np.testing.assert_array_equal(counts, want)
