"""Strand and optimization-score enums of the pattern tables
(reference: src/base_pattern.h, src/Global.h)."""

from __future__ import annotations

from enum import Enum


class Strand(Enum):
    PLUS_STRAND = 0
    BOTH_STRANDS = 1


class OptimizationScore(Enum):
    LOGPVAL = 0
    ENRICHMENT = 1
    MUTUAL_INFO = 2
