"""MEME-minimal and JSON motif writers, byte-compatible with the
reference (reference: src/peng.cpp:602-728).

Both writers apply the zero-free epsilon adjustment *in place* on the
motif PWMs, and motifs are sorted by log p-value before writing — exactly
like the reference, including the consequence that writing MEME first and
JSON second applies the epsilon twice (src/main.cpp:69-75 does the same).

Stream-state quirk, reproduced byte-for-byte: the reference switches its
output stream to std::fixed/precision(8) when printing the first PWM
(src/peng.cpp:650) and never restores it, so the bg_prob/log(Pval)
header floats of every motif after the first print in fixed-8 notation
instead of the 6-significant-digit default.  ``_StreamFloat`` models
exactly that.
"""

from __future__ import annotations

from typing import List

from .models.motif import Motif, sort_by_log_pvalue
from .utils.numerics import cpp_float, no_zero_pwm

PRECISION = 8


class _StreamFloat:
    """C++ ostream float formatting incl. persistent std::fixed state."""

    def __init__(self):
        self.fixed = False

    def __call__(self, x) -> str:
        if self.fixed:
            return f"{float(x):.{PRECISION}f}"
        return cpp_float(x)

    def set_fixed(self):
        self.fixed = True


def write_meme(
    motifs: List[Motif],
    path: str,
    bg_freq,
    iupac_profile,
    alphabet: str = "ACGT",
):
    """MEME minimal v4 with nsites/bg_prob/opt_bg_order/log(Pval) header
    extensions (reference: src/peng.cpp:602-659)."""
    motifs[:] = sort_by_log_pvalue(motifs)
    ordered = motifs
    fmt = _StreamFloat()
    with open(path, "w") as f:
        f.write("MEME version 4\n\n")
        f.write(f"ALPHABET= {alphabet}\n\n")
        f.write("Background letter frequencies\n")
        f.write(
            " ".join(
                f"{alphabet[i]} {fmt(bg_freq[i])}"
                for i in range(len(alphabet))
            )
        )
        f.write("\n\n")
        for motif in ordered:
            f.write(f"MOTIF {motif.pattern_string(iupac_profile)}\n")
            f.write(
                "letter-probability matrix:"
                f" alength= 4"
                f" w= {motif.length}"
                f" nsites= {motif.n_sites}"
                f" bg_prob= {fmt(motif.bg_p)}"
                f" opt_bg_order= {motif.opt_bg_order}"
                f" log(Pval)= {fmt(motif.log_pvalue)}\n"
            )
            no_zero_pwm(motif.pwm, PRECISION)
            fmt.set_fixed()
            for w in range(motif.length):
                f.write(
                    " ".join(f"{motif.pwm[w][a]:.{PRECISION}f}"
                             for a in range(4))
                )
                f.write("\n")
            f.write("\n")


def write_json(
    motifs: List[Motif],
    path: str,
    bg_freq,
    iupac_profile,
    alphabet: str = "ACGT",
):
    """JSON writer (reference: src/peng.cpp:662-728), replicating the
    reference's exact whitespace/layout."""
    ordered = sort_by_log_pvalue(motifs)
    fmt = _StreamFloat()
    with open(path, "w") as f:
        f.write("{\n")
        f.write(f'\t"alphabet" : "{alphabet}",\n')
        f.write(
            '\t"bg" : ['
            + ", ".join(fmt(bg_freq[i]) for i in range(len(alphabet)))
            + "],\n"
        )
        f.write('\t"alphabet_length" : 4,\n')
        f.write('\t"patterns" : [\n')
        for idx, motif in enumerate(ordered):
            f.write("\t\t{\n")
            f.write(
                f'\t\t\t"iupac_motif" : '
                f'"{motif.pattern_string(iupac_profile)}",\n'
            )
            f.write(f'\t\t\t"pattern_length" : {motif.length},\n')
            f.write(f'\t\t\t"sites" : {motif.n_sites},\n')
            f.write(f'\t\t\t"log(Pval)" : {fmt(motif.log_pvalue)},\n')
            f.write(f'\t\t\t"bg_prob" : {fmt(motif.bg_p)},\n')
            f.write(f'\t\t\t"opt_bg_order" : {motif.opt_bg_order},\n')
            f.write('\t\t\t"pwm" : [\n')
            no_zero_pwm(motif.pwm, PRECISION)
            fmt.set_fixed()
            for w in range(motif.length):
                row = ", ".join(
                    f"{motif.pwm[w][a]:.{PRECISION}f}" for a in range(4)
                )
                f.write(f"\t\t\t\t\t[{row}]")
                if w != motif.length - 1:
                    f.write(", ")
                f.write("\n")
            f.write("\t\t\t\t]\n")
            f.write("\t\t}")
            if idx != len(ordered) - 1:
                f.write(",")
            f.write("\n")
        f.write("\t]\n")
        f.write("}\n")
