"""Device milliseconds of the ops launched inside the program's
``rays.table`` spans (``build_patch_table``, ``make_pair_table`` and the
adaptive loop's ``build_pair``) over the flow steps profiled."""


def read(summary, cell):
    s = (summary.get("stage_device_s") or {}).get("rays.table", 0.0)
    if s <= 0 or not summary["steps"]:
        return None
    return 1e3 * s / summary["steps"]
