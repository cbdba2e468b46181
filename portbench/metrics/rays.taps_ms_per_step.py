"""Device milliseconds of the taps path's gathers over the flow steps
profiled. ``rays/interp._gather_taps`` gathers with one ``index_select``
of the flat field stack a stage, which PyTorch runs on the card as its
gather kernel (``_scatter_gather_elementwise_kernel<...,
_cuda_scatter_gather_internal_kernel<false, OpaqueType<4>, int>>``).
Nothing else in a taps cell's frame launches that kernel: the profiled
launches are 4 a step."""

KERNEL = "_scatter_gather_elementwise_kernel"


def read(summary, cell):
    s = sum(sec for name, (_, sec) in summary["device_ops"].items() if KERNEL in name)
    if s <= 0 or not summary["steps"]:
        return None
    return 1e3 * s / summary["steps"]
