"""The control of ``correct``: for each seed, one short run of the cell
(set-up, a window of ``--seconds``) whose jobs are checked as a
benchmark run checks them, and beside the program's readings the
control's: the plain reference computed in the precision below the
stated one (TF32 contractions, float32 for the stated float64 sums; see
:mod:`bench_port.reference.motifs`) put in the program's place.

    python3 -m bench_port.control --workload NAME --seeds 1,2,3 [--seconds 2]

One JSON line per seed: {"seed", "correct", "program": {number:
reading}, "control": {number: reading}, "control_correct"}, where
``control_correct`` holds the control's readings to the cell's limits as
a run holds the program's (:func:`bench_port.checks.judge`): the control
has to come out not correct.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

from . import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = R.load_cell(args.workload)
    for seed in [int(x) for x in args.seeds.split(",")]:
        tmp = tempfile.mkdtemp(prefix="bench_port_control_")
        try:
            res = R.run(cell, seed, args.seconds, False, args.device, tmp,
                        control=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(dict(
            seed=seed, correct=res["correct"], jobs=res["attempted"],
            program={k: v[0] for k, v in res["checked"].items()},
            control=res["control"],
            control_correct=res["control_correct"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
