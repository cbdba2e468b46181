"""The pair-table kernel's share of its roofline: the least time its
function can take (``portbench/roofline``: both field stacks read once,
2 x F x nx^2 float32 values with F the configuration's channels, and the
table written once, nx^2 rows of ``table_row_bytes`` at the table's
dtype, at the HBM bandwidth) for each launch profiled, over the device
time of those launches. Found by kernel name, as
``rays.pair_table_ms_per_step`` finds it; a program without the kernel
reads nothing."""
from portbench import roofline

KERNEL = "pair_table_kernel"
FIELD_BYTES = 4


def pair_table_bytes(nx: int, interp: str, table_dtype: str) -> float:
    """Bytes of one (old|new) pair-table build on an nx x nx grid."""
    channels = roofline.PATCH[interp][2]
    return nx * nx * (2 * channels * FIELD_BYTES + roofline.table_row_bytes(interp, table_dtype))


def read(summary, cell):
    hits = [(c, s) for name, (c, s) in summary["device_ops"].items() if KERNEL in name]
    count, sec = sum(c for c, _ in hits), sum(s for _, s in hits)
    if not count or sec <= 0:
        return None
    nbytes = pair_table_bytes(summary["nx"], summary["interp"], summary["table_dtype"])
    return 100.0 * count * roofline.bound_s(nbytes) / sec
