"""The share of the profiled stretch in which no kernel, copy or set runs
on the card: 100 (1 - busy / window), busy the union of the device's
intervals in the trace."""


def read(summary, cell):
    w = summary["window_s"]
    if w <= 0 or not summary["device_ops"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / w)
