"""Device milliseconds of the cuFFT kernels over the flow steps profiled.
cuFFT names its kernels after their passes (``regular_fft``,
``vector_fft``, ``composite_2way_fft``, ``..._c2r``/``_r2c``): every device
operation whose name holds ``fft``, in any case, and is none of the port's
own kernels."""
import re

PATTERN = re.compile(r"fft", re.IGNORECASE)
OWN = ("ray_step", "ray_attempt", "birth_death", "probe")


def read(summary, cell):
    s = sum(sec for name, (_, sec) in summary["device_ops"].items()
            if PATTERN.search(name) and not any(o in name for o in OWN))
    if s <= 0 or not summary["steps"]:
        return None
    return 1e3 * s / summary["steps"]
