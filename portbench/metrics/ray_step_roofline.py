"""The RK4 table kernel's share of its roofline: the least time its
function can take (``portbench/roofline.ray_step_bytes`` at the HBM
bandwidth: the pair-table rows of the cells holding a packet at the
configuration's table dtype, the state read and the output written) for
each launch profiled, over the device time of those launches."""
from portbench import roofline

KERNEL = "ray_step_table_kernel"


def read(summary, cell):
    hits = [(c, s) for name, (c, s) in summary["device_ops"].items() if KERNEL in name]
    count, sec = sum(c for c, _ in hits), sum(s for _, s in hits)
    if not count or sec <= 0:
        return None
    nbytes = roofline.ray_step_bytes(summary["held_rows"], summary["n_packets"],
                                     summary["interp"], summary["table_dtype"])
    return 100.0 * count * roofline.bound_s(nbytes) / sec
