"""Share of the traced window (a few whole jobs) in which the card ran
no kernel, copy or fill: 100 * (1 - union of the device spans /
window), from torch.profiler's trace."""


def read(rec):
    t = rec["trace"]
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
