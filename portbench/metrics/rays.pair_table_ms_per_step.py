"""Device milliseconds of the pair-table kernel over the flow steps
profiled. ``ops/pair_table`` builds the (old|new) pair table with one
launch of ``csrc/pair_table.cu``'s ``pair_table_kernel`` (one a step in an
RK4 frame, one a step in the adaptive loop); found by kernel name, since a
replayed CUDA graph runs no span. No other kernel's name holds it; a
program without the kernel reads nothing."""

KERNEL = "pair_table_kernel"


def read(summary, cell):
    s = sum(sec for name, (_, sec) in summary["device_ops"].items() if KERNEL in name)
    if s <= 0 or not summary["steps"]:
        return None
    return 1e3 * s / summary["steps"]
