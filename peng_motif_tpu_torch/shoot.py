"""Wrapper that runs the port's motif discovery engine and re-ranks the
found motifs with an external classification score.

    python -m peng_motif_tpu_torch.shoot FASTA_FILE -o out.meme [...]

The port's own copy of the reference repository's
``scripts/shoot_peng.py`` (reference wrapper: scripts/shoot_peng.py:
33-300), with the same argparse surface and behaviors — run the engine,
abort with the reference's exit codes, optionally run BaMMmotif2's
``FDR`` + ``plotPvalStats.R`` to compute the AUSFC ("zoops") score per
motif, re-rank, and rewrite MEME/JSON with ``zoops_score``/``occur``
fields — plus ``--device`` and ``--engine``, which go to the port's CLI.
The engine runs in-process (``peng_motif_tpu_torch.cli.main``) unless
``--peng-binary`` points at an external executable, which is given the
reference's flags only; the external scoring tools are optional
dependencies probed on PATH exactly like the reference does.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from .cli import main as engine_main
from .device import DEVICES

RSCRIPT = "plotPvalStats.R"
FDR = "FDR"


def check_executable_presence(executable_name):
    if not shutil.which(executable_name):
        print('|ERROR| Cannot find %s. Please install it and check your '
              'PATH variable.' % executable_name, file=sys.stderr)
        return False
    return True


def build_parser():
    parser = argparse.ArgumentParser(
        description='A wrapper for PEnG that reranks the found motifs')
    parser.add_argument(metavar='FASTA_FILE', dest='fasta_file', type=str,
                        help='file with the input fasta sequences')
    parser.add_argument("-o", metavar='FILE', dest='meme_output_file',
                        type=str, help='best IUPAC motives will be written '
                        'in FILE in minimal MEME format')
    parser.add_argument("-j", metavar='FILE', dest='json_output_file',
                        type=str, help='best IUPAC motives will be written '
                        'in OUTPUT_FILE in JSON format')
    parser.add_argument("-d", "--output_directory", metavar='DIR',
                        dest='output_directory', type=str,
                        help='directory for the temporary files')
    parser.add_argument('--background-sequences', metavar='FASTA_FILE',
                        dest='background_sequences', type=str,
                        help='file with fasta sequences to be used for the '
                        'background model calculation')
    parser.add_argument('-w', metavar='INT', dest='pattern_length', type=int,
                        default=10)
    parser.add_argument('-t', metavar='FLOAT', dest='zscore_threshold',
                        type=float, default=10)
    parser.add_argument('--count-threshold', metavar='INT',
                        dest='count_threshold', type=int, default=1)
    parser.add_argument('--bg-model-order', metavar='INT',
                        dest='bg_model_order', type=int, default=2)
    parser.add_argument('--strand', metavar='PLUS|BOTH', dest='strand',
                        type=str, default='BOTH', choices=['PLUS', 'BOTH'])
    parser.add_argument('--optimization_score',
                        metavar='LOGPVAL|EXPCOUNTS|MUTUAL_INFO',
                        dest='optimization_score', type=str,
                        default='MUTUAL_INFO',
                        choices=['ENRICHMENT', 'LOGPVAL', 'MUTUAL_INFO'])
    parser.add_argument('--enrich_pseudocount_factor', type=float,
                        default=0.005, metavar="FLOAT")
    parser.add_argument('--no-em', dest='use_em', action='store_false',
                        default=True)
    parser.add_argument('-a', metavar='FLOAT',
                        dest='em_saturation_threshold', type=float,
                        default=1E4)
    parser.add_argument('--em-threshold', metavar='FLOAT',
                        dest='em_threshold', type=float, default=0.08)
    parser.add_argument('--em-max-iterations', metavar='INT',
                        dest='em_max_iterations', type=int, default=100)
    parser.add_argument('--no-merging', dest='use_merging',
                        action='store_false', default=True)
    parser.add_argument('--max_merged_length', metavar='INT',
                        dest='max_merged_length', type=int, default=14)
    parser.add_argument('-b', metavar='FLOAT', dest='bit_factor_threshold',
                        type=float, default=0.4)
    parser.add_argument('--use-default-pwm', action='store_true',
                        dest='use_default_pwm', default=False)
    parser.add_argument('--pseudo-counts', metavar='INT',
                        dest='pseudo_counts', type=int, default=10)
    parser.add_argument('--threads', metavar='INT', dest='number_threads',
                        type=float, default=1)
    parser.add_argument('--silent', action='store_true',
                        help='capture and suppress output on stdout')
    parser.add_argument('--stdout_output_file',
                        help='write engine output to file instead of stdout')
    parser.add_argument('--no-scoring', action='store_true',
                        help='skip the calculation of the pwm performance '
                        'score')
    parser.add_argument('--no-neighbor-filtering', action='store_true')
    parser.add_argument('--minimum-processed-patterns', type=int, default=25)
    parser.add_argument('--maximum-optimized-patterns', type=int, default=50)
    parser.add_argument('--peng-binary', default=None,
                        help='run this external peng_motif executable '
                        'instead of the in-process engine')
    parser.add_argument('--device', default='cuda', choices=DEVICES,
                        help='device of the in-process engine')
    parser.add_argument('--engine', default='auto',
                        choices=['auto', 'tpu', 'exact'],
                        help='engine of the in-process run')
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.meme_output_file is None and args.json_output_file is None:
        print("Warning: you did not define an output file (options -o or "
              "-j). Stopping here.", file=sys.stderr)
        sys.exit(1)

    required_tools = []
    if args.peng_binary:
        required_tools.append(args.peng_binary)
    if not args.no_scoring:
        required_tools += [RSCRIPT, FDR]

    ready = True
    for tool in required_tools:
        if not check_executable_presence(tool):
            ready = False
    if not ready:
        sys.exit(10)

    output_directory = args.output_directory
    if args.output_directory is None:
        with tempfile.TemporaryDirectory() as output_directory:
            run_peng(args, output_directory, not args.no_scoring)
    else:
        if not os.path.exists(output_directory):
            os.makedirs(output_directory)
        run_peng(args, output_directory, not args.no_scoring)


def build_engine_argv(args, peng_output_file, peng_json_file):
    """Flag list for the engine (reference: shoot_peng.py:123-155)."""
    argv = [os.path.abspath(args.fasta_file),
            "-j", os.path.abspath(peng_json_file),
            "-o", os.path.abspath(peng_output_file)]
    if args.background_sequences:
        argv += ["--background-sequences",
                 os.path.abspath(args.background_sequences)]
    argv += ["-w", str(args.pattern_length)]
    argv += ["-t", str(args.zscore_threshold)]
    argv += ["--count-threshold", str(args.count_threshold)]
    argv += ["--bg-model-order", str(args.bg_model_order)]
    argv += ["--strand", args.strand]
    argv += ["--optimization_score", str(args.optimization_score)]
    argv += ["--enrich_pseudocount_factor",
             str(args.enrich_pseudocount_factor)]
    if not args.use_em:
        argv += ["--no-em"]
    argv += ["-a", str(args.em_saturation_threshold)]
    argv += ["--em-threshold", str(args.em_threshold)]
    argv += ["--em-max-iterations", str(args.em_max_iterations)]
    if not args.use_merging:
        argv += ["--no-merging"]
    if args.use_default_pwm:
        argv += ["--use-default-pwm"]
    argv += ["--max_merged_length", str(args.max_merged_length)]
    argv += ["-b", str(args.bit_factor_threshold)]
    argv += ["--pseudo-counts", str(args.pseudo_counts)]
    argv += ["--threads", str(args.number_threads)]
    argv += ['--minimum-processed-patterns',
             str(args.minimum_processed_patterns)]
    argv += ['--max-optimized-patterns', str(args.maximum_optimized_patterns)]
    if args.no_neighbor_filtering:
        argv.append('--no-neighbor-filtering')
    return argv


def run_engine(args, peng_output_file, peng_json_file):
    argv = build_engine_argv(args, peng_output_file, peng_json_file)
    if args.peng_binary:
        if args.stdout_output_file:
            with open(args.stdout_output_file, 'w') as stdout:
                result = subprocess.run([args.peng_binary] + argv,
                                        stdout=stdout)
        else:
            stdout = subprocess.DEVNULL if args.silent else None
            result = subprocess.run([args.peng_binary] + argv, stdout=stdout)
        return result.returncode

    # in-process engine: no subprocess round trip
    argv += ["--device", args.device, "--engine", args.engine]
    try:
        if args.stdout_output_file:
            with open(args.stdout_output_file, 'w') as fh, \
                    contextlib.redirect_stdout(fh):
                return engine_main(argv)
        if args.silent:
            with contextlib.redirect_stdout(io.StringIO()):
                return engine_main(argv)
        return engine_main(argv)
    except SystemExit as e:  # the engine CLI exits on argument errors
        return int(e.code or 0)


def build_fdr_command(args, protected_fasta_file, peng_output_file,
                     output_directory):
    """reference: shoot_peng.py:158-171 (FDR -m 1 -k 0 --cvFold 1 ...)."""
    command = [FDR, output_directory, os.path.abspath(protected_fasta_file),
               "--PWMFile", os.path.abspath(peng_output_file)]
    if args.strand == 'PLUS':
        command += ["--ss"]
    command += ["--maxPosN", 10000]
    command += ["--negN", 10000]
    command += ["-k", 0]
    command += ["--cvFold", 1]
    command += ["--parallizeOverMotifs"]
    return [str(s) for s in command]


def run_peng(args, output_directory, run_scoring):
    filename, _ = os.path.splitext(args.fasta_file)
    prefix = os.path.basename(filename)
    prefix = re.sub(re.compile(r'\s+'), '_', prefix)

    peng_output_file = os.path.join(output_directory, prefix + ".tmp.out")
    peng_json_file = os.path.join(output_directory, prefix + ".tmp.json")

    returncode = run_engine(args, peng_output_file, peng_json_file)
    if returncode != 0:
        sys.exit(returncode)

    with open(peng_json_file) as fh:
        peng_data = json.load(fh)

    if not len(peng_data['patterns']):
        print('|ERROR| no enriched patterns found. You can find very short '
              'or weak patterns by reducing the z-score threshold or the '
              'pattern length')
        sys.exit(8)

    if run_scoring:
        stdout = subprocess.DEVNULL if args.silent else None
        fdr_command_line = build_fdr_command(
            args, args.fasta_file, peng_output_file, output_directory)
        subprocess.run(fdr_command_line, check=True, stdout=stdout)

        r_output_file = os.path.join(output_directory, prefix + ".bmscore")
        subprocess.run([RSCRIPT, os.path.abspath(output_directory), prefix],
                       check=True, stdout=stdout)

        rank_scores = {}
        occur = {}
        with open(r_output_file) as fh:
            for line in fh:
                if line.startswith("prefix"):
                    continue
                try:
                    (_, motif_number, data_aurrc, _, _, motif_occur,
                     *_) = line.split()
                    motif_number = int(motif_number)
                except ValueError:
                    continue
                occur[motif_number] = float(motif_occur)
                try:
                    rank_scores[motif_number] = float(data_aurrc)
                except ValueError:
                    rank_scores[motif_number] = np.nan

        for idx, p in enumerate(peng_data["patterns"], start=1):
            if idx in rank_scores:
                p["zoops_score"] = rank_scores[idx]
                p["occur"] = occur[idx]
                print("{} {}".format(p["iupac_motif"], p["zoops_score"]))
            else:
                p["zoops_score"] = np.nan

        peng_data["patterns"] = sorted(
            peng_data["patterns"], key=lambda k: k['zoops_score'],
            reverse=True)
    else:
        for p in peng_data["patterns"]:
            p["zoops_score"] = float('nan')
            p["occur"] = float('nan')

    if args.meme_output_file:
        write_meme(peng_data, args.meme_output_file)
    if args.json_output_file:
        write_json(peng_data, args.json_output_file)


def write_meme(peng_data, peng_output_file):
    """MEME v4 writer with zoops_score/occur header extensions
    (reference: shoot_peng.py:261-293)."""
    with open(peng_output_file, "w") as fh:
        print("MEME version 4", file=fh)
        print(file=fh)
        print("ALPHABET= " + peng_data["alphabet"], file=fh)
        print(file=fh)
        print("Background letter frequencies", file=fh)
        bg_probs = []
        for idx, nt in enumerate(peng_data["alphabet"]):
            bg_probs.append(nt)
            bg_probs.append(str(peng_data["bg"][idx]))
        print(" ".join(bg_probs), file=fh)
        print(file=fh)

        for p in peng_data["patterns"]:
            print("MOTIF {}".format(p["iupac_motif"]), file=fh)
            print(
                ("letter-probability matrix: alength= {} w= {} nsites= {} "
                 "bg_prob= {} opt_bg_order= {} log(Pval)= {} "
                 "zoops_score= {} occur= {}").format(
                    peng_data["alphabet_length"], p["pattern_length"],
                    p["sites"], p["bg_prob"], p["opt_bg_order"],
                    p["log(Pval)"], p["zoops_score"], p['occur']), file=fh)
            for line in p["pwm"]:
                print(" ".join(['{:.8f}'.format(x) for x in line]), file=fh)
            print(file=fh)


def write_json(peng_data, json_output_file):
    with open(json_output_file, 'w') as fh:
        json.dump(peng_data, fh)


if __name__ == '__main__':
    main()
