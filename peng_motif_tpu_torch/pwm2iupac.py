"""Translate a PWM (one whitespace-separated ACGT row per line) into its
nearest IUPAC string and print it.

    python -m peng_motif_tpu_torch.pwm2iupac PWM_FILE

The port's own copy of the repository's ``scripts/pwm2iupac.py`` (the
port imports nothing of the reference package): the same arguments,
output and exit codes (1 on a row that is not four numbers summing to
0.9-1.1).  Semantics of the reference converter (reference:
scripts/pwm2iupac.py:88-193): fixed background [0.2, 0.3, 0.3, 0.2],
profile mixin c=0.2 / t=0.7, the symmetric-KL-style distance
d = sum (p1-p2)(log2 p1 - log2 p2), and the reference's N-profile quirk —
N has no ACGT representative here, so its profile is pure background
mixin (unlike the engine's renderer, where N covers all four bases).
"""

import argparse
import sys

import numpy as np

IUPAC_CHARS = "ACGTSWRYMKN"

# per-letter ACGT representative sets (reference: pwm2iupac.py:33-65;
# N intentionally has none — see module docstring)
REPRESENTATIVES = {
    0: [0], 1: [1], 2: [2], 3: [3],
    4: [1, 2],   # S
    5: [0, 3],   # W
    6: [0, 2],   # R
    7: [1, 3],   # Y
    8: [0, 1],   # M
    9: [2, 3],   # K
    10: [],      # N (quirk)
}

BG_MODEL = np.array([0.2, 0.3, 0.3, 0.2])


def init_iupac_profiles(c=0.2, t=0.7):
    profiles = np.zeros((len(IUPAC_CHARS), 4))
    for code, reps in REPRESENTATIVES.items():
        profiles[code] = c * BG_MODEL
        for r in reps:
            profiles[code][r] += t
    return profiles


def calculate_d(profile1, profile2):
    """d = sum (p1-p2) * (log2 p1 - log2 p2)
    (reference: pwm2iupac.py:114-119)."""
    return float(np.sum(
        (profile1 - profile2) * (np.log2(profile1) - np.log2(profile2))
    ))


def get_iupac_string(pwm, profiles):
    out = []
    for row in pwm:
        dists = [calculate_d(row, profiles[m])
                 for m in range(len(IUPAC_CHARS))]
        out.append(IUPAC_CHARS[int(np.argmin(dists))])
    return "".join(out)


def read_pwm(filename):
    pwm = []
    with open(filename) as fh:
        for line in fh:
            tokens = line.split()
            if len(tokens) != 4:
                print("ERROR: line does not seem to be part of a valid "
                      "pwm!!!", file=sys.stderr)
                print("\t{}".format(line), file=sys.stderr)
                sys.exit(1)
            profile = np.array([float(t) for t in tokens])
            if not (0.9 < profile.sum() < 1.1):
                print("ERROR: line does not seem to be part of a valid "
                      "pwm!!!", file=sys.stderr)
                print("\t{}".format(line), file=sys.stderr)
                sys.exit(1)
            pwm.append(profile)
    return pwm


def main():
    parser = argparse.ArgumentParser(
        description='Translates a PWM into an IUPAC identifier and prints '
        'it')
    parser.add_argument(metavar='PWM_FILE', dest='pwm_file', type=str,
                        help='file with the pwm')
    args = parser.parse_args()
    pwm = read_pwm(args.pwm_file)
    print(get_iupac_string(pwm, init_iupac_profiles()))


if __name__ == '__main__':
    main()
