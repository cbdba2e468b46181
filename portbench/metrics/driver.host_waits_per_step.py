"""The program's host waits on the device (``bool``, ``float``, ``int``,
``.item()``, ``.tolist()``, ``.cpu()`` of a device tensor, each counted
once at its site in ``observability.waits``) over the flow steps
profiled."""


def read(summary, cell):
    waits = summary["counters"].get("host_waits")
    if waits is None or not summary["steps"]:
        return None
    return waits / summary["steps"]
