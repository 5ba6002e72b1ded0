"""End-to-end check of the sharded count: the whole pipeline over a mesh
against the same pipeline on one device.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` of the reference
package.

    python -m peng_motif_tpu_torch.parallel.dryrun [N] [cuda|cpu]
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import tempfile

import numpy as np


def write_dryrun_corpus(path: str) -> None:
    """The reference dry run's corpus, from its seed: 160 x 220 bp with
    a planted motif in every third sequence (so seed selection, the
    lockstep climb with its host replay, adv-PWM, EM and the merge loop
    all execute), tandem repeats with gaps < W (forcing the
    suspicious-chunk dedup fix-up), N runs (post-N skip semantics and
    the background model's N quirks), and one 2,600 bp contig (the
    halo-split path)."""
    rng = np.random.default_rng(1)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    motif = b"TGACTCAC"
    rows = []
    for i in range(160):
        s = bytearray(letters[rng.integers(0, 4, size=220)].tobytes())
        if i % 3 == 0:
            p = int(rng.integers(0, len(s) - len(motif)))
            s[p : p + len(motif)] = motif
        if i % 11 == 0:
            s[40:64] = b"ACGTACGT" * 3
        if i % 17 == 0:
            s[100:106] = b"N" * 6
        rows.append(bytes(s))
    rows.append(letters[rng.integers(0, 4, size=2600)].tobytes())
    with open(path, "wb") as f:
        for i, r in enumerate(rows):
            f.write(b">s%d\n%s\n" % (i, r))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the complete W=8 pipeline of the device engine over an
    ``n_devices`` mesh on ``device`` and assert it reproduces the
    single-device run byte for byte.  The mesh leg runs the sharded
    stream count with its integer sums and the fused background
    histogram's (parallel/sharded.stream_count_sharded); byte-equal MEME
    output and stdout against the one-device engine is the end-to-end
    certificate of the whole communication surface."""
    from ..cli import main  # noqa: PLC0415

    with tempfile.TemporaryDirectory(prefix="peng_dryrun_") as tmp:
        fasta = os.path.join(tmp, "dryrun.fasta")
        write_dryrun_corpus(fasta)

        def run(devices_flag):
            out_path = os.path.join(tmp, f"out_{devices_flag or 1}.meme")
            argv = [fasta, "-w", "8", "-o", out_path, "--engine", "tpu",
                    "--device", device]
            if devices_flag:
                argv += ["--devices", str(devices_flag)]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            if rc != 0:
                raise RuntimeError(
                    f"pipeline rc={rc} (devices={devices_flag})")
            with open(out_path, "rb") as f:
                return buf.getvalue(), f.read()

        stdout_1, meme_1 = run(None)
        stdout_n, meme_n = run(n_devices)
    if b"MOTIF" not in meme_1:
        raise AssertionError("no motif discovered in the dry-run corpus")
    if meme_n != meme_1:
        raise AssertionError("mesh .meme differs from single-device")
    if stdout_n != stdout_1:
        raise AssertionError("mesh stdout differs from single-device")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print("dryrun_multichip ok")
