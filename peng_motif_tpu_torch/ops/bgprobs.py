"""Background probability tables as a per-position dynamic program, on
the rank-W tensor.

Counterpart of ``peng_motif_tpu/ops/bgprobs.py``.  The reference binary
fills the 4**W background-probability table with a recursive 4-ary tree
walk per Markov order (src/base_pattern.cpp:285-325):

    P(pattern) = prod_{l=0}^{W-1} v[min(l,k)][ letters max(0,l-k)..l ]

Here the recursion is W broadcast multiplies of the rank-W table by
small conditional-probability tensors, in position order with one f32
rounding per factor, so every entry is bit-equal to the reference
package's table and to ``flat_tables.bg_prob_flat`` reshaped.

Axis convention: see ops/encoding.py (tensor axis a = position W-1-a).
The BaMM conditional table v[k] is big-endian over its (k+1)-mer
(earliest letter has factor 4**k, src/base_pattern.h:88-103), so v[k]
reshaped row-major to (4,)*(k+1) has axes ordered (earliest..latest) =
*descending* tensor-axis order; reversing those axes aligns it with the
rank-W layout.

Double-strand aggregation (src/base_pattern.cpp:268-283):
non-palindromic entries hold p(fwd) + p(revcomp); palindromes stay.

The reference module's host f32 functions (``host_bg_prob_flat``,
``host_aggregate_double_strand_flat``) have no copy here: the port's
host table is the native one (native.bg_prob_table_native_fn, in the
exact engine); the device engine's seed selection reads the stats
program's table (engine.process_gpu), the same bits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import encoding


def bg_prob_table(v: Sequence[torch.Tensor], length: int,
                  order: int) -> torch.Tensor:
    """The rank-W f32 background probability tensor for one Markov order.

    v[j]: [4**(j+1)] conditional table (big-endian BaMM layout) for
    j = 0..order, all on the device the table is built on.
    """
    dev = v[0].device
    prob = torch.ones((4,) * length, dtype=torch.float32, device=dev)
    for pos in range(length):
        k_eff = min(pos, order)
        cond = v[k_eff].to(torch.float32).reshape((4,) * (k_eff + 1))
        # reshaped axes run earliest->latest position = descending tensor
        # axis; reverse to ascending-axis (latest->earliest) order
        cond = cond.permute(tuple(reversed(range(k_eff + 1))))
        # target axes axis_of_pos(pos) .. axis_of_pos(pos - k_eff)
        a_hi = encoding.axis_of_pos(length, pos)
        shape = ((1,) * a_hi + (4,) * (k_eff + 1)
                 + (1,) * (length - a_hi - k_eff - 1))
        prob = prob * cond.reshape(shape)
    return prob


def aggregate_double_strand(prob: torch.Tensor) -> torch.Tensor:
    """Sum forward + reverse-complement probabilities at both ids;
    palindromes untouched (reference: src/base_pattern.cpp:268-283)."""
    ids = encoding.pattern_ids_tensor(prob.ndim, prob.device)
    return torch.where(ids == encoding.rc_permute(ids), prob,
                       prob + encoding.rc_permute(prob))
