"""The host's kernel and graph launch API calls (``cudaLaunchKernel``,
``cuLaunchKernel``, ``cudaGraphLaunch`` and their variants, as the trace
names them) over the flow steps profiled: a count."""


def read(summary, cell):
    if not summary["launch_calls"] or not summary["steps"]:
        return None
    return summary["launch_calls"] / summary["steps"]
