"""The device engine's seed selection on the CPU
(peng_motif_tpu_torch/engine.py, ``count.seeds``): the background table
it reads is the stats program's, fetched from the device, and it must be
the host fold (native.bg_prob_table_native_fn, the table the seeds were
selected from before) bit for bit, on MafK_100seqs at -w 4 to 12, with
background orders 0 to 3, on both strands and on the plus strand.  The
same check on the card is tests/test_torch_gpu.py::
test_seeds_bgp_from_the_card_is_the_host_fold.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from conftest import GOLDEN_DIR

from peng_motif_tpu_torch import cli, engine
from peng_motif_tpu_torch.io.fasta import load_sequence_set
from peng_motif_tpu_torch.models.background import BackgroundModel
from peng_motif_tpu_torch.native import bg_prob_table_native_fn

MAFK = os.path.join(GOLDEN_DIR, "MafK_100seqs.fasta")


@pytest.fixture(scope="module")
def mafk_v():
    """The MafK_100seqs background's conditionals, by order."""
    seqs = load_sequence_set(MAFK).sequences
    return {k: BackgroundModel(seqs, order=k).v for k in range(4)}


def _host_fold(v, W, order, both):
    return bg_prob_table_native_fn(
        [np.asarray(x, dtype=np.float32) for x in v[: order + 1]], W, order,
        both)


@pytest.mark.parametrize("both", [True, False], ids=["both", "plus"])
@pytest.mark.parametrize("order", range(4))
@pytest.mark.parametrize("W", range(4, 13))
def test_seeds_bgp_is_the_host_fold(W, order, both, mafk_v):
    k = min(W - 1, order)   # the engine's current_k
    v = mafk_v[order][: k + 1]
    none = np.zeros(0, dtype=np.int32)
    state = engine.resident_state(np.zeros(4 ** W, np.int32), 12_345, none,
                                  none, v, "cpu")
    got = engine.stats_program(state, W, k, k, both)["bgp"].numpy()
    want = _host_fold(v, W, k, both)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("strand", ["BOTH", "PLUS"])
def test_seed_selection_reads_the_fetched_bgp(strand, monkeypatch,
                                              tmp_path, mafk_v):
    """A whole -w 8 job: the table ``base_stats_native`` gets is the host
    fold of the job's background, and the seeds' spans are recorded."""
    seen = []
    real = engine.base_stats_native

    def spy(counts, bgp, ltot):
        seen.append(np.array(bgp))
        return real(counts, bgp, ltot)

    monkeypatch.setattr(engine, "base_stats_native", spy)
    err = io.StringIO()
    argv = [MAFK, "-w", "8", "--strand", strand, "--device", "cpu",
            "--engine", "tpu", "-o", str(tmp_path / "o.meme"), "--timing"]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    (bgp,) = seen
    want = _host_fold(mafk_v[2], 8, 2, strand == "BOTH")
    np.testing.assert_array_equal(bgp.view(np.uint32), want.view(np.uint32))
    for part in ("bgp", "stats", "sort", "walk"):
        assert f"[TIMING] count.seeds.{part}: " in err.getvalue(), part
