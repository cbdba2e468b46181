"""Accepted plus rejected DP5(4) attempts over the flow steps profiled, as
the adaptive loop counts them in the info of each step
(``CoupledDriver.ray_infos``)."""


def read(summary, cell):
    c = summary["counters"]
    n = c["attempts_accepted"] + c["attempts_rejected"]
    if not n or not summary["steps"]:
        return None
    return n / summary["steps"]
