"""Arithmetic shared by the readers."""

from __future__ import annotations

import json
import os
import statistics


def mean_phase_ms(rec, name):
    vals = [j["phases"][name] for j in rec["jobs"] if name in j["phases"]]
    return statistics.fmean(vals) * 1e3 if vals else None


def peaks(kind):
    """The published peaks of a card, by the name torch gives it."""
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "peaks.json")) as f:
        return json.load(f).get(kind)
