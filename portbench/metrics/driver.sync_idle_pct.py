"""The share of the profiled stretch in which the device sits idle in a
gap that holds the end of one of the program's ``wait.*`` spans: the
device drained while the host waited on it, and stays idle until the host
launches again. 100 sync_idle_s / window_s."""


def read(summary, cell):
    spans = summary.get("spans") or {}
    if not any(name.startswith("wait.") for name in spans) or summary["window_s"] <= 0:
        return None
    return 100.0 * summary["sync_idle_s"] / summary["window_s"]
