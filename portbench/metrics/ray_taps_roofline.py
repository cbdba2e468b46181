"""The taps gather's share of its roofline: the least time of one gather's
function for each launch profiled, over the device time of the launches
of the kernel that runs ``rays/interp._gather_taps``'s ``index_select``
(``metrics/rays.taps_ms_per_step``).

One gather takes F fields at T taps of N packets: it reads the F T N
float32 values once and their F T N flat indices once (int32, as
``_gather_taps`` makes them), and writes F T N float32 once, at the HBM
bandwidth."""
from portbench import roofline

KERNEL = "_scatter_gather_elementwise_kernel"
# interp -> (fields a gather takes, taps a packet)
TAPS = {"bilinear": (5, 4), "bspline": (5, 16), "bicubic": (20, 4)}
VALUE_BYTES = INDEX_BYTES = 4


def ray_taps_bytes(n: int, interp: str) -> float:
    """Bytes of one taps gather's function for ``n`` packets."""
    fields, taps = TAPS[interp]
    return fields * taps * n * (2 * VALUE_BYTES + INDEX_BYTES)


def read(summary, cell):
    hits = [(c, s) for name, (c, s) in summary["device_ops"].items() if KERNEL in name]
    count, sec = sum(c for c, _ in hits), sum(s for _, s in hits)
    if not count or sec <= 0:
        return None
    nbytes = ray_taps_bytes(summary["n_packets"], summary["interp"])
    return 100.0 * count * roofline.bound_s(nbytes) / sec
