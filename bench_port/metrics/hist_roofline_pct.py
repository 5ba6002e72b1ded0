"""The histogram kernels' share of their bound in the traced jobs: the
least time of every stream-count call (each input id, 4 B, and flag,
1 B, read once, each bin, 4 B, written once, at the card's published
memory rate) over the profiler's time of ``hist_shared_kernel`` and
``hist_l2_kernel``."""

from bench_port.metrics._common import peaks


def bound_s(n, bins, bytes_per_s):
    return (5 * n + 4 * bins) / bytes_per_s


def read(rec):
    t = rec["trace"]
    card = peaks(rec["device_kind"])
    if not t or not t["hist_calls"] or not t["hist_s"] or not card:
        return None
    least = sum(bound_s(n, b, card["hbm_bytes_per_s"])
                for n, b in t["hist_calls"])
    return 100.0 * least / t["hist_s"]
