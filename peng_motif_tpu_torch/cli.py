"""Flag-compatible command-line interface.

Mirrors the reference CLI surface exactly (reference:
src/Global.cpp:77-375, src/main.cpp:18-84), including its hand-rolled
parsing behaviors: unknown options warn and are ignored; odd pattern
lengths are rejected with exit code 4.  The port adds ``--device`` and
runs the reference package's extensions: ``--engine``, the checkpoint
flags, ``--profile`` (a torch.profiler trace), ``--timing``,
``--devices`` (the count sharded over a device mesh) and the
multi-process flags (the count sharded over processes joined by
torch.distributed).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from . import __version__
from .checkpoint import CheckpointError
from .device import DEVICES, DeviceUnavailable, resolve_device
from .io.fasta import FastaFormatError, load_sequence_set, read_fasta_lengths
from .models.background import BackgroundModel
from .output import write_json, write_meme
from .parallel.mesh import make_data_mesh
from .parallel.multihost import (
    init_multihost,
    multihost_bg_counts,
    multihost_stream_counts,
    shutdown_multihost,
)
from .parallel.sharded import count_bg_kmers_sharded
from .pattern_tables import OptimizationScore, Strand
from .pipeline import Peng, PengParameters, resolve_engine
from .utils import logging_utils
from .utils.logging_utils import (
    PhaseTimer,
    get_logger,
    set_verbosity,
    span,
    torch_profile,
)

HELP = """
=================================================================

 Usage: peng_motif SEQFILE [options]

\t SEQFILE: file with sequences in FASTA format.

      -o, <OUTPUT_FILE>
           best IUPAC motives will be written in OUTPUT_FILE
           in minimal MEME format

      -j, <OUTPUT_FILE>
           best IUPAC motives will be written in OUTPUT_FILE
           in JSON format

      --background-sequences, <FASTA_FILE>
           file with fasta sequences to be used for the
           background model calculation

      -t, <ZSCORE_THRESHOLD>
           lower zscore threshold for basic patterns

      -w, <PATTERN_LENGTH>
           length of patterns to be searched

      --bg-model-order, <BG_MODEL_ORDER>
           order of the background model

      --count-threshold, <COUNT_THRESHOLD>
           lower threshold for counts of basic patterns

      --strand, <PLUS|BOTH>
           select the strands to work on

      --optimization_score, <ENRICHMENT|LOGPVAL|MUTUAL_INFO>
           select the iupac optimization score

      --enrich_pseudocount_factor, <PSEUDO_COUNTS>
           add (enrich_pseudocount_factor x #seqs) pseudocounts
           in the EXPCOUNTS optimization

      -b, <BIT_FACTOR_THRESHOLD>
           bit factor threshold for merging IUPAC patterns

      --no-em
           shuts off the em optimization

      -a, <EM_SATURATION_THRESHOLD>
           saturation factor for em optimization

      --em-threshold, <EM_THRESHOLD>
           threshold for finishing the em optimization

      --em-max-iterations, <EM_MAX_ITERATIONS>
           max number of em optimization iterations

      --no-merging
           shuts off the merging

      --max_merged_length
           define the maximum length of motifs after merging

      --use-default-pwm
           use the default calculation of the pwm

      --pseudo-counts, <PSEUDO_COUNTS>
           number of pseudo-counts for optimization

      --threads, <NUMBER_THREADS>
           number of threads to be used for parallelization

      --no-neighbor-filtering
           do not filter similar base patterns before running the optimization

      --minimum-processed-patterns <NUMBER_PATTERNS>
           minimum number of iupac patterns that are selected for em optimization

      --version
           print the version number

      -h
           print this help

      --max-optimized-patterns
           maximum number of iupac patterns that are selected for pattern optimization

 PyTorch/CUDA port extensions:

      --device <cuda|cpu>      device of the 4**W-table phases (default
                               cuda; cuda without a CUDA device is an
                               error)
      --engine <tpu|exact|auto>
                               tpu: the device engine on --device;
                               exact: byte-parity host engine;
                               auto (default): tpu on --device cuda for
                               -w < 12, exact otherwise
      --profile <TRACE_DIR>    write a torch.profiler Chrome trace of
                               the whole job (TRACE_DIR/trace.json), the
                               job's spans in it
      --save-checkpoint <DIR>  persist count table + background model
      --load-checkpoint <DIR>  resume from a persisted count table
      --timing                 print the job's spans and counters on
                               stderr, its last output:
                               "[TIMING] <path>: <ms> ms (<calls>)" per
                               span path (a child's path is its parent's
                               and its name joined by "."; top level:
                               parse, background, count, optimize,
                               replay, pwm, em+merge, redundancy,
                               output), then "[COUNT] <name>: <n>":
                               syncs (host waits for the device: blocking
                               reads and uploads), h2d.copies, h2d.bytes
      --devices <N>            shard the count over N devices: cuda:0..N-1
                               (more than the machine has is an error), or
                               N shards in turn on --device cpu; with
                               --num-processes, the devices of each process
      --num-processes <N>      multi-process run: total process count
      --process-id <I>         multi-process run: this process's index
                               (process 0 writes all output)
      --coordinator <HOST:PORT>
                               multi-process run: rendezvous address

=================================================================
"""


def _need_value(args, i, flag):
    if i + 1 >= len(args):
        print(HELP)
        print(f"No expression following {flag}", file=sys.stderr)
        sys.exit(4)
    return args[i + 1]


def _need_count(args, i, flag, minimum):
    """The integer following ``flag``, at least ``minimum``."""
    val = _need_value(args, i, flag)
    try:
        n = int(val)
    except ValueError:
        n = None
    if n is None or n < minimum:
        print(HELP)
        print(f"{flag} takes an integer >= {minimum}, got {val!r}",
              file=sys.stderr)
        sys.exit(4)
    return n


def parse_args(argv):
    """Hand-rolled parse loop mirroring Global::readArguments
    (reference: src/Global.cpp:77-314)."""
    if len(argv) > 1 and argv[1] == "-h":
        print(HELP)
        sys.exit(0)
    if len(argv) > 1 and argv[1] == "-version":
        print(f"peng_motif version {__version__}")
        sys.exit(0)
    if len(argv) < 2:
        print("Error: Arguments are missing! ", file=sys.stderr)
        print(HELP)
        sys.exit(-1 & 0xFF)

    cfg = {
        "input": argv[1],
        "background_sequences": None,
        "output": None,
        "json": None,
        "pattern_length": 10,
        "zscore_threshold": 10.0,
        "count_threshold": 3,
        "pseudo_counts": 10,
        "opt_score_type": OptimizationScore.MUTUAL_INFO,
        "enrich_pseudocount_factor": 0.005,
        "use_em": True,
        "em_saturation_factor": 1e4,
        "em_min_threshold": 0.08,
        "em_max_iterations": 10,
        "use_merging": True,
        "bit_factor_merge_threshold": 0.4,
        "max_merged_length": 14,
        "adv_pwm": True,
        "strand": Strand.BOTH_STRANDS,
        "bg_model_order": 2,
        "max_opt_bg_model_order": 2,
        "filter_neighbors": True,
        "minimum_processed_motifs": 0,
        "max_optimized_patterns": 50,
        "verbosity": 2,
        "threads": 1,
        "device": "cuda",
        "devices": None,
        "engine": "auto",
        "profile": None,
        "save_checkpoint": None,
        "load_checkpoint": None,
        "timing": False,
        "num_processes": 1,
        "process_id": 0,
        "coordinator": "localhost:29500",
    }

    i = 2
    while i < len(argv):
        arg = argv[i]
        if arg == "-w":
            cfg["pattern_length"] = int(_need_value(argv, i, arg)); i += 1
            if cfg["pattern_length"] % 2 == 1:
                print(
                    "Due to optimizations the pattern length has to be a "
                    "multiple of 2", file=sys.stderr,
                )
                sys.exit(4)
        elif arg == "--background-sequences":
            cfg["background_sequences"] = _need_value(argv, i, arg); i += 1
        elif arg == "--optimization_score":
            val = _need_value(argv, i, arg); i += 1
            mapping = {
                "LOGPVAL": OptimizationScore.LOGPVAL,
                "ENRICHMENT": OptimizationScore.ENRICHMENT,
                "MUTUAL_INFO": OptimizationScore.MUTUAL_INFO,
            }
            if val not in mapping:
                print(HELP)
                print("Unknown expression following --optimization_score",
                      file=sys.stderr)
                sys.exit(4)
            cfg["opt_score_type"] = mapping[val]
        elif arg == "--enrich_pseudocount_factor":
            cfg["enrich_pseudocount_factor"] = float(_need_value(argv, i, arg)); i += 1
        elif arg == "-v":
            cfg["verbosity"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "-o":
            cfg["output"] = _need_value(argv, i, arg); i += 1
        elif arg == "-j":
            cfg["json"] = _need_value(argv, i, arg); i += 1
        elif arg == "-t":
            cfg["zscore_threshold"] = float(_need_value(argv, i, arg)); i += 1
        elif arg == "--count-threshold":
            cfg["count_threshold"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "-b":
            cfg["bit_factor_merge_threshold"] = float(_need_value(argv, i, arg)); i += 1
        elif arg == "--use-default-pwm":
            cfg["adv_pwm"] = False
        elif arg == "--pseudo-counts":
            cfg["pseudo_counts"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--threads":
            cfg["threads"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--no-em":
            cfg["use_em"] = False
        elif arg == "-a":
            cfg["em_saturation_factor"] = float(_need_value(argv, i, arg)); i += 1
        elif arg == "--em-threshold":
            cfg["em_min_threshold"] = float(_need_value(argv, i, arg)); i += 1
        elif arg == "--em-max-iterations":
            cfg["em_max_iterations"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--no-merging":
            cfg["use_merging"] = False
        elif arg == "--max_merged_length":
            cfg["max_merged_length"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--strand":
            val = _need_value(argv, i, arg); i += 1
            if val == "BOTH":
                cfg["strand"] = Strand.BOTH_STRANDS
            elif val == "PLUS":
                cfg["strand"] = Strand.PLUS_STRAND
            else:
                print(HELP)
                print("Unknown expression following --strand", file=sys.stderr)
                sys.exit(4)
        elif arg == "--bg-model-order":
            cfg["bg_model_order"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--no-neighbor-filtering":
            cfg["filter_neighbors"] = False
        elif arg == "--minimum-processed-patterns":
            cfg["minimum_processed_motifs"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--max-optimized-patterns":
            cfg["max_optimized_patterns"] = int(_need_value(argv, i, arg)); i += 1
        elif arg == "--version":
            print(f"peng_motif {__version__}")
            sys.exit(0)
        elif arg == "-h":
            print(HELP)
            sys.exit(0)
        elif arg == "--engine":
            val = _need_value(argv, i, arg); i += 1
            if val not in ("tpu", "exact", "auto"):
                print(HELP)
                print("Unknown expression following --engine",
                      file=sys.stderr)
                sys.exit(4)
            cfg["engine"] = val
        elif arg == "--profile":
            cfg["profile"] = _need_value(argv, i, arg); i += 1
        elif arg == "--save-checkpoint":
            cfg["save_checkpoint"] = _need_value(argv, i, arg); i += 1
        elif arg == "--load-checkpoint":
            cfg["load_checkpoint"] = _need_value(argv, i, arg); i += 1
        elif arg == "--device":
            val = _need_value(argv, i, arg); i += 1
            if val not in DEVICES:
                print(HELP)
                print("Unknown expression following --device",
                      file=sys.stderr)
                sys.exit(4)
            cfg["device"] = val
        elif arg == "--timing":
            cfg["timing"] = True
        elif arg == "--devices":
            cfg["devices"] = _need_count(argv, i, arg, 1); i += 1
        elif arg == "--num-processes":
            cfg["num_processes"] = _need_count(argv, i, arg, 1); i += 1
        elif arg == "--process-id":
            cfg["process_id"] = _need_count(argv, i, arg, 0); i += 1
        elif arg == "--coordinator":
            cfg["coordinator"] = _need_value(argv, i, arg); i += 1
        else:
            print(f"Ignoring unknown option {arg}", file=sys.stderr)
        i += 1
    return cfg


def _run_multihost_worker(cfg, ctx) -> int:
    """A process other than 0 of a multi-process run: take part in the
    two collective phases (background sum, sharded stream count) without
    parsing the full corpus — a lengths-only scan plus range decodes of
    this block's sequences — and neither print nor write anything.  The
    order of the collectives must mirror process 0's exactly."""
    bg_path = cfg["background_sequences"] or cfg["input"]
    bg_model_order = max(cfg["bg_model_order"], cfg["max_opt_bg_model_order"])
    try:
        lengths = read_fasta_lengths(cfg["input"])
        if bg_path == cfg["input"]:
            multihost_bg_counts(ctx, None, bg_model_order,
                                input_path=cfg["input"],
                                n_total=len(lengths))
        else:
            bg_set = load_sequence_set(bg_path)
            multihost_bg_counts(ctx, bg_set.sequences, bg_model_order)
        multihost_stream_counts(
            ctx, None, cfg["pattern_length"],
            cfg["strand"] == Strand.BOTH_STRANDS,
            input_path=cfg["input"], lengths=lengths)
    except OSError as e:
        print(f"Error: Cannot open FASTA file: {e.filename or e}",
              file=sys.stderr)
        return 1
    except FastaFormatError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    # the job's spans and counters, from before the first argument is read
    recorder = PhaseTimer()
    with recorder.activate():
        argv = list(sys.argv) if argv is None else ["peng_motif"] + list(argv)
        cfg = parse_args(argv)
        set_verbosity(cfg["verbosity"])
        with torch_profile(cfg["profile"], cfg["device"], recorder):
            rc = _job(cfg, recorder)
    if rc == 0 and cfg["timing"] and cfg["process_id"] == 0:
        recorder.report()
    return rc


def _job(cfg, recorder) -> int:
    multihost = cfg["num_processes"] > 1
    cold = logging_utils.take_cold_start(recorder)
    try:
        with span("device") if cold else contextlib.nullcontext():
            device = resolve_device(cfg["device"])
            if cold and device.type == "cuda":
                torch.empty(1, device=device)   # the CUDA context
        # the mesh of --devices: the whole run's without --num-processes,
        # each process's local one with it
        mesh = (make_data_mesh(cfg["devices"], device)
                if cfg["devices"] is not None else None)
    except (DeviceUnavailable, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if not multihost:
        return _run(cfg, device, mesh, None, recorder)
    ctx = init_multihost(cfg["coordinator"], cfg["num_processes"],
                         cfg["process_id"], device=device, mesh=mesh)
    try:
        if cfg["process_id"] != 0:
            # worker process: no full parse, no output
            return _run_multihost_worker(cfg, ctx)
        get_logger().info(
            f"multi-process count: {ctx.world} processes, "
            f"{sum(ctx.shards)} shards, backend {ctx.backend}")
        return _run(cfg, device, None, ctx, recorder)
    finally:
        shutdown_multihost()


def _run(cfg, device, mesh, ctx, recorder) -> int:
    """The job of a single process, or of process 0 of a multi-process
    run (``ctx``: its parallel/multihost.MultihostContext)."""
    try:
        with span("parse"):
            sequence_set, bg_set, bg_path = _parse(cfg)
    except OSError as e:
        # reference: src/shared/SequenceSet.cpp:445-448
        print(f"Error: Cannot open FASTA file: {e.filename or e}",
              file=sys.stderr)
        return 1
    except FastaFormatError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    with span("background"):
        bg_model = _background(cfg, device, mesh, ctx, bg_set, bg_path)

    precomputed = None
    if ctx is not None:
        # the one corpus-wide phase: the stream count sharded over every
        # process's devices and summed; process 0 alone goes on from here
        with span("multihost"):
            precomputed = multihost_stream_counts(
                ctx, sequence_set.sequences, cfg["pattern_length"],
                cfg["strand"] == Strand.BOTH_STRANDS,
                flat_codes=getattr(sequence_set, "_flat_codes", None))

    peng = Peng(
        cfg["strand"], cfg["bg_model_order"], cfg["max_opt_bg_model_order"],
        sequence_set, bg_model, timer=recorder,
    )
    params = PengParameters(
        max_pattern_length=cfg["pattern_length"],
        zscore_threshold=cfg["zscore_threshold"],
        count_threshold=cfg["count_threshold"],
        pseudo_counts=cfg["pseudo_counts"],
        opt_score_type=cfg["opt_score_type"],
        enrich_pseudocount_factor=cfg["enrich_pseudocount_factor"],
        use_em=cfg["use_em"],
        em_saturation_factor=cfg["em_saturation_factor"],
        em_min_threshold=cfg["em_min_threshold"],
        em_max_iterations=cfg["em_max_iterations"],
        use_merging=cfg["use_merging"],
        bit_factor_merge_threshold=cfg["bit_factor_merge_threshold"],
        adv_pwm=cfg["adv_pwm"],
        minimum_processed_motifs=cfg["minimum_processed_motifs"],
        filter_neighbors=cfg["filter_neighbors"],
        max_optimized_patterns=cfg["max_optimized_patterns"],
        max_merged_length=cfg["max_merged_length"],
        device=device,
        mesh=mesh,
        engine=cfg["engine"],
        save_checkpoint=cfg["save_checkpoint"],
        load_checkpoint=cfg["load_checkpoint"],
        precomputed=precomputed,
        threads=cfg["threads"] if cfg["threads"] > 1 else 0,
    )

    try:
        result = peng.process(params)
        with span("redundancy"):
            peng.filter_redundancy(cfg["bit_factor_merge_threshold"],
                                   result)
    except CheckpointError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    with span("output"):
        if cfg["output"]:
            write_meme(result, cfg["output"], bg_model.v[0],
                       peng.iupac_profile)
        if cfg["json"]:
            write_json(result, cfg["json"], bg_model.v[0],
                       peng.iupac_profile)
    return 0


def _parse(cfg):
    """(sequence set, background set, background path); raises OSError
    or FastaFormatError."""
    sequence_set = load_sequence_set(cfg["input"])
    # the reference always constructs a second SequenceSet for the
    # background (src/Global.cpp:66-74), re-parsing the input when no
    # separate file is given; share the parse but replay its warnings so
    # stderr stays byte-identical
    bg_path = cfg["background_sequences"] or cfg["input"]
    if bg_path == cfg["input"]:
        for w in sequence_set.warnings:
            print(w, file=sys.stderr)
        return sequence_set, sequence_set, bg_path
    return sequence_set, load_sequence_set(bg_path), bg_path


def _background(cfg, device, mesh, ctx, bg_set, bg_path) -> BackgroundModel:
    bg_model_order = max(cfg["bg_model_order"], cfg["max_opt_bg_model_order"])
    # defer: the device engine fuses the (k+1)-mer scan into the count
    # (ops/stream_count.stream_bg_counts) and delivers the counts — no
    # host corpus scan at all.  Only when the device engine runs a count
    # (no checkpoint), the bg corpus IS the input corpus and the
    # fused-histogram gates hold (the engine re-checks and starts the
    # threaded host scan otherwise, or on a fallback to the exact engine).
    defer_bg = (
        ctx is None
        and bg_path == cfg["input"]
        and bg_model_order <= 3
        and cfg["pattern_length"] >= 5  # fused bg needs ctx = 2(W-1) >= 8
        and not cfg["load_checkpoint"]
        and resolve_engine(cfg["engine"], device,
                           cfg["pattern_length"]) == "tpu"
    )
    if ctx is not None:
        # background (k+1)-mer vectors summed over the processes
        return BackgroundModel(
            counts=multihost_bg_counts(ctx, bg_set.sequences,
                                       bg_model_order),
            order=bg_model_order, interpolate=True)
    if mesh is not None and not defer_bg:
        # sharded (k+1)-mer scan summed over the mesh (reference serial
        # analogue: src/shared/BackgroundModel.cpp:59-84)
        lengths = np.array([len(s) for s in bg_set.sequences],
                           dtype=np.int32)
        return BackgroundModel(
            counts=count_bg_kmers_sharded(bg_set.padded(), bg_model_order,
                                          mesh, lengths=lengths),
            order=bg_model_order, interpolate=True)
    # lazy: the (k+1)-mer scan runs in a thread and overlaps the device
    # count (first .v access joins)
    return BackgroundModel(
        bg_set.sequences, order=bg_model_order, interpolate=True,
        defer=defer_bg, lazy=not defer_bg,
    )


# the end of the package's import: the cold-start span setup.import
logging_utils.mark_imported()


if __name__ == "__main__":
    sys.exit(main())
