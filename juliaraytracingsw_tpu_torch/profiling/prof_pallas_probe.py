"""Does a hand kernel build and run, and how fast is the fused substep?
(port of ``benchmarks/profiling/prof_pallas_probe.py``)

Stage 1: an elementwise ``2x + 1`` on (256, 256), the copy kernel's plain
mode. Stages 2-3: the ray path's ``raytrace_tables`` through the RK4 table
kernel (which reads the pair table itself) at 65,536 and 1,048,576 packets, over the pair table of two
white-noise 512^2 bilinear field stacks (seed 0), one substep of 1e-3.
The 65,536-packet stage is held against the same call on the CPU, which
runs the kernel's plain version.

    python -m juliaraytracingsw_tpu_torch.profiling prof_pallas_probe
"""
from __future__ import annotations

import math
import numpy as np
import torch

from ..ops import probes
from ..rays.packets import Packets
from ..rays.patch import build_patch_table
from ..rays.raytrace import RayParams, make_pair_table, raytrace_tables
from ._timing import Result, measure, time_ms

NX = NY = 512
STAGE_N = (1 << 16, 1 << 20)
H = 1e-3
# one packet's stages read 40 of its 160 pair-row values while they stay in
# its base cell; with its state in (5 values) and out (4) that is the least
# it must move
BYTES_PER_PACKET = (40 + 5 + 4) * 4
# stage 2 against the CPU: the kernel and its plain version compute the same
# formulas up to FMA contraction; over white-noise fields (|grad u| ~ 1e2
# cells) one substep's rounding reaches ~1e-6 in the positions
RTOL, ATOL = 1e-5, 1e-5


def _substep(p: Packets, T_pair, rp) -> Packets:
    return raytrace_tables(p, T_pair, 0.0, H, rp, NY, NX, nsubsteps=1, method="rk4")


def run(device, card: str) -> list[Result]:
    print(f"# prof_pallas_probe [{card}]", flush=True)
    rng = np.random.default_rng(0)
    sched, a, b, shape = probes.COPY_PROBES["trivial"]
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
    # 1 + 2x in one call, bit-equal: 2x is exact, so a fused multiply-add
    # rounds as the product and the sum do
    ones = torch.ones_like(x)
    out = [measure("stage 1: trivial 2x + 1, (256, 256) f32, plain loads", card,
                   kernel="probe_copy", n_rows=shape[0], nbytes=2 * x.numel() * 4,
                   fn=lambda: probes.staged_copy(x, sched, a, b),
                   plain=lambda: probes.staged_copy_torch(x, sched, a, b),
                   library=lambda: torch.add(ones, x, alpha=a), library_name="torch.add")]

    fo, fn_ = (torch.as_tensor(rng.standard_normal((5, NY, NX)).astype(np.float32),
                               device=device) for _ in range(2))
    T_pair = make_pair_table(build_patch_table(fo, "bilinear"), build_patch_table(fn_, "bilinear"))
    del fo, fn_
    rp = RayParams(f=3.0, Cg=1.0, x0=-math.pi, y0=-math.pi, dx=2 * math.pi / NX,
                   dy=2 * math.pi / NY)
    for stage, n in zip((2, 3), STAGE_N):
        xy = rng.uniform(-math.pi, math.pi, (2, n)).astype(np.float32)
        p = Packets(*(torch.as_tensor(v, device=device) for v in
                      (xy[0], xy[1], np.full(n, 5.0, np.float32), np.zeros(n, np.float32),
                       np.ones(n, np.float32))))
        got = _substep(p, T_pair, rp)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(v).all()) for v in got):
            raise AssertionError(f"stage {stage}: non-finite packets")
        err = None
        if stage == 2:
            ref = _substep(Packets(*(v.cpu() for v in p)), T_pair.cpu(), rp)
            err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
            for g, r in zip(got, ref):
                torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)
        ms = time_ms(lambda: _substep(p, T_pair, rp))
        res = Result(f"stage {stage}: raytrace_tables, RK4 table kernel, N={n}", None, ms, n,
                     n * BYTES_PER_PACKET, max_abs_err=err)
        held = (f"; GPU vs CPU max |difference| {err:.3e} (rtol {RTOL}, atol {ATOL})"
                if err is not None else "")
        print(f"{res.line(card)}; {n / ms / 1e3:.1f} M rays/s{held}", flush=True)
        out.append(res)
    return out

