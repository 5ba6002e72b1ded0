"""Device mesh construction for data-parallel counting.

Counterpart of ``peng_motif_tpu/parallel/mesh.py``.  A mesh is a plain
tuple of ``torch.device``: shard ``i`` of the corpus is counted on entry
``i``, and the per-shard tables are summed onto entry 0.  The sharded
functions (parallel/sharded.py) take any tuple and do not ask whether
its entries are distinct.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Mesh = Tuple[torch.device, ...]


def make_data_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """``n_devices`` shards on ``device``'s kind.

    On ``cuda`` the mesh is ``cuda:0 … cuda:n-1`` (every card when
    ``n_devices`` is None); asking for more cards than there are, or
    for fewer than one, raises: it is never cut to the cards there are.  On ``cpu`` it is ``n``
    entries of ``cpu`` (one when ``n_devices`` is None): virtual shards
    that run in turn, the counterpart of XLA's forced host device count
    that the reference's mesh tests run on."""
    kind = torch.device(device).type
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"requested {n_devices} devices, need at least 1")
    if kind == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"make_data_mesh: unsupported device {device}")
    available = torch.cuda.device_count()
    if n_devices is None:
        n_devices = available
    if n_devices > available:
        raise ValueError(
            f"requested {n_devices} devices, only {available} available")
    return tuple(torch.device("cuda", i) for i in range(n_devices))
