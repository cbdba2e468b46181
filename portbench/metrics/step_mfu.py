"""The whole step's share of the card's float32 peak: the floating-point
work the profiled steps' algorithms need (``portbench/roofline`` over the
configuration's ``work``: the flow step's transforms and block applies,
the interpolation fields, each ray attempt's stages, ``work``'s
``ray_flops_per_packet`` where the configuration states it and the
method's count otherwise) over the profiled stretch's seconds times 67
TFLOP/s."""
from portbench import roofline


def read(summary, cell):
    steps, w = summary["steps"], summary["window_s"]
    if not steps or w <= 0:
        return None
    n, work = summary["nx"], cell.config["work"]
    flops = steps * roofline.flow_step_flops(work, n)
    if summary["coupled"]:
        flops += steps * roofline.fields_flops(work, n)
        method = summary["ray_method"]
        c = summary["counters"]
        attempts = (c["attempts_accepted"] + c["attempts_rejected"]
                    if method != "rk4" else steps)
        per_packet = work.get("ray_flops_per_packet")
        if per_packet is None:
            per_packet = roofline.ray_flops_per_packet(method)
        flops += attempts * summary["n_packets"] * per_packet
    else:
        flops += summary["frames"] * roofline.fields_flops(work, n)
    return 100.0 * flops / (w * roofline.FP32_FLOPS_PER_S)
