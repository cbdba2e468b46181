"""The birth/death kernel's share of its roofline: the least time its
function can take for each launch profiled (``portbench/roofline.
birth_death_bytes`` at the HBM bandwidth: a live packet's seven words read,
a dead one's two, all seven written and a byte of the dead mask), over the
device time of those launches. The deaths a launch are the ``births``
counter's growth over the profiled frames over the launches. Found by
kernel name, since a replayed CUDA graph runs no span; a program without
the kernel reads nothing."""
from portbench import roofline

KERNEL = "birth_death_kernel"


def read(summary, cell):
    hits = [(c, s) for name, (c, s) in summary["device_ops"].items() if KERNEL in name]
    count, sec = sum(c for c, _ in hits), sum(s for _, s in hits)
    if not count or sec <= 0:
        return None
    deaths = summary["counters"]["births"] / count
    nbytes = roofline.birth_death_bytes(summary["n_packets"], deaths)
    return 100.0 * count * roofline.bound_s(nbytes) / sec
