"""The DP5(4) table attempt kernel's share of its roofline: the least time
of one attempt's function (``portbench/roofline.ray_attempt_bytes`` at the
HBM bandwidth) for each launch profiled, over their device time."""
from portbench import roofline

KERNEL = "ray_attempt_table_kernel"


def read(summary, cell):
    hits = [(c, s) for name, (c, s) in summary["device_ops"].items() if KERNEL in name]
    count, sec = sum(c for c, _ in hits), sum(s for _, s in hits)
    if not count or sec <= 0:
        return None
    nbytes = roofline.ray_attempt_bytes(summary["held_rows"], summary["n_packets"],
                                        summary["interp"], summary["table_dtype"])
    return 100.0 * count * roofline.bound_s(nbytes) / sec
