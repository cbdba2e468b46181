"""Device milliseconds of the ops launched inside the program's
``flow.step`` spans (the flow model's step: IF-AB3's transforms, products
and block applies) over the flow steps profiled."""


def read(summary, cell):
    s = (summary.get("stage_device_s") or {}).get("flow.step", 0.0)
    if s <= 0 or not summary["steps"]:
        return None
    return 1e3 * s / summary["steps"]
