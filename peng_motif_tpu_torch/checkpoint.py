"""Checkpoint / resume for the count-table artifact.

The reference has no checkpointing; counting is the only phase that
scans the input, so the checkpoint artifact is the 4**W count table +
ltot + the background model.  Resuming skips the input count entirely
(reference scan: src/base_pattern.cpp:331-441).

Format (the reference package's, so a checkpoint written by either
package loads in the other): ``counts_w{W}_{strand}.npz`` (counts,
ltot) next to a BaMM-format background model file (``bg.hbcp``,
reference format: src/shared/BackgroundModel.cpp:406-488) and a
``checkpoint.json`` naming the configuration.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from .models.background import BackgroundModel

_META = "checkpoint.json"


class CheckpointError(RuntimeError):
    """A checkpoint exists but does not fit the run (another -w or
    strand) or is incomplete."""


def _counts_name(pattern_length: int, strand_name: str) -> str:
    return f"counts_w{pattern_length}_{strand_name.lower()}.npz"


def save_checkpoint(directory: str, pattern_length: int, strand_name: str,
                    counts: np.ndarray, ltot: int,
                    bg_model: BackgroundModel) -> None:
    os.makedirs(directory, exist_ok=True)
    np.savez_compressed(
        os.path.join(directory, _counts_name(pattern_length, strand_name)),
        counts=np.asarray(counts, dtype=np.int32),
        ltot=np.int64(ltot),
    )
    bg_model.name = "bg"
    bg_model.write(directory)
    meta = {
        "pattern_length": pattern_length,
        "strand": strand_name,
        "bg_order": bg_model.order,
    }
    with open(os.path.join(directory, _META), "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(directory: str, pattern_length: int, strand_name: str
                    ) -> Optional[Tuple[np.ndarray, int, BackgroundModel]]:
    """Returns (counts, ltot, bg_model); raises CheckpointError on a
    config-mismatched or malformed checkpoint, returns None if absent."""
    counts_path = os.path.join(
        directory, _counts_name(pattern_length, strand_name))
    if not os.path.exists(counts_path):
        meta_path = os.path.join(directory, _META)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            raise CheckpointError(
                f"checkpoint at {directory} was written for "
                f"-w {meta.get('pattern_length')} --strand "
                f"{meta.get('strand')}; requested -w {pattern_length} "
                f"--strand {strand_name}")
        return None
    data = np.load(counts_path)
    counts = data["counts"]
    ltot = int(data["ltot"])
    bg_path = os.path.join(directory, "bg.hbcp")
    if not os.path.exists(bg_path):
        raise CheckpointError(f"checkpoint at {directory} is missing bg.hbcp")
    return counts, ltot, BackgroundModel.read(bg_path)
