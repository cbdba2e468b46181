"""Drive the PyTorch/CUDA port of juliaraytracingsw_tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them, and on any failed check. Phases, each printing its lines:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the build of the kernels (``csrc/ray_step.cu``, the fused RK4 substep,
   ``csrc/ray_attempt.cu``, the fused DP5(4) attempt, and the probe
   kernels' three sources) by nvcc, one process per source;
2. the RK4 kernel against its plain PyTorch twin at N = 1,048,576 packets
   for each interpolation (bilinear, bspline, bicubic), each timed on the
   device in a CUDA graph, as the probes are; 2b. the same for the attempt kernel, whose error row is also
   held at a step where the truncation error is far above round-off;
2c. the probe entry point (``juliaraytracingsw_tpu_torch.profiling``, the
   port of the Pallas probe scripts in ``benchmarks/profiling/``): every
   probe at its script's shapes through the copy and gather kernels
   (``csrc/probe_copy.cu``, ``csrc/probe_gather.cu``,
   ``csrc/probe_row_ring.cu``), each held bit-equal to its plain version
   and timed beside its bound and its PyTorch library call;
3. one coupled frame at 128^2 x 16,384 packets on the GPU (kernel) against
   the same frame on the CPU (twin); 3b. the same for one adaptive frame;
4. the hero through ``CoupledDriver``: 512^2 RSW stepped by IF-AB3, coupled
   to 1,048,576 WKB packets over bfloat16 bilinear patch tables, spun up
   200 flow steps and run 4 frames of 5 coupled steps; then 2 frames each
   of the bspline and bicubic rows of the same path;
4b. the adaptive hero: the same flow and packets with the adaptive DP5(4)
   ray integrator at the reference's tolerances (rtol 1e-3, atol 1e-6),
   3 frames of 5 coupled steps from the initial condition, the accepted
   and rejected attempts of one interval; then 1 frame each of its
   bspline and bicubic rows.

The kernels' launch counts are set to 0 before each main path (2c, 4 and
4b) and read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

F, CG, DT = 3.0, 1.0, 1e-3          # the hero's f, Cg and flow dt
K0 = float(np.sqrt(3.0) * F / CG)
K_CUTOFF = 100.0 * F / CG
INTERPS = ("bilinear", "bspline", "bicubic")
KERNEL_SOURCE = "juliaraytracingsw_tpu_torch/csrc/ray_step.cu"
REPLACES = "juliaraytracingsw_tpu/ops/pallas_ray_step.py:284"
ATTEMPT_SOURCE = "juliaraytracingsw_tpu_torch/csrc/ray_attempt.cu"
ATTEMPT_REPLACES = "juliaraytracingsw_tpu/ops/pallas_ray_step.py:462"
# the probe kernels' rows in the kernels line: (module, probe-name prefix,
# source, the Pallas kernels replaced), each the probe at the shapes nearest
# the ray path's gather
PROF = "benchmarks/profiling/"
PROBE_KERNELS = {
    "probe_copy": ("prof_r5_dma_bisect", "k1 ", "juliaraytracingsw_tpu_torch/csrc/probe_copy.cu",
                   f"{PROF}prof_pallas_probe.py:48, {PROF}prof_r5_dma_bisect.py:51, :65, :81, "
                   ":99, :122, :158"),
    "gather_elems": ("prof_pallas_gather", "k1 ",
                     "juliaraytracingsw_tpu_torch/csrc/probe_gather.cu",
                     f"{PROF}prof_pallas_gather.py:51, :86, {PROF}prof_pallas2.py:41, "
                     f"{PROF}prof_pallas3.py:40, :71"),
    "gather_rows": ("prof_r5_dma_probe", "take W=160 f32",
                    "juliaraytracingsw_tpu_torch/csrc/probe_gather.cu",
                    f"{PROF}prof_pallas2.py:71, :103, :140"),
    "row_ring": ("prof_r5_dma_probe", "per-row copy ring K=8 f32, 16 blocks",
                 "juliaraytracingsw_tpu_torch/csrc/probe_row_ring.cu",
                 f"{PROF}prof_r5_dma_probe.py:133, {PROF}prof_r5_dma2.py:78, :146, "
                 f"{PROF}prof_r5_dma_bisect2.py:67"),
}
# the adaptive hero's options (bench.py:207-209): the reference's
# production tolerances, one attempt per interval to start
HERO_ADAPTIVE = dict(rtol=1e-3, atol=1e-6, max_steps=16, init_substeps=1, loop="while")

# phase 2: kernel vs twin, the same formulas in the same order up to FMA
# contraction
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
# phase 3: GPU vs CPU after 5 coupled steps. cuFFT and the CPU's FFT round
# differently (the port matches the JAX package to 2e-7 of the largest mode
# on the CPU); the packets also see the kernel's FMA contraction.
FRAME_SOL_RTOL = 1e-5
FRAME_PACKET_ATOL = 1e-4
# phase 2b, the attempt's error row esum = |h (b - b4) . k / scale|^2 per
# packet, which cancels O(1-10) stage slopes down to the truncation error.
# At the hero's dt that error lies below float32's resolution: the batch
# norm sqrt(sum(esum) / 4N) is ~1e-6 and round-off (on the CPU the float32
# twin's norm is 2% (bilinear) to 80% (bicubic) off its float64 value), so
# the bounds above do not test esum there. It is held in a second attempt
# where the truncation error is far above round-off: h = 20 hero dt at
# rtol = atol = 1e-6, batch norm ~0.2, the scale on which the controller
# decides. The packets then move about two cells, into the patch's clamped
# extension, which kernel and twin compute alike. Bounds: rows 0-3 as
# above, esum to 1% of its largest value, the batch norm to 1e-3 relative
# (the float32 twin against float64 on the CPU at N = 16,384: 1.9e-3 of
# the largest esum, 5.1e-5 in the norm).
TRUNC_H, TRUNC_TOL = 20 * DT, 1e-6
ESUM_ATOL_OF_MAX, NORM_RTOL = 1e-2, 1e-3
# rows_T values a packet's stages read when they stay in its base cell:
# 5 fields x 2x2 taps (4x4 bspline; 4 Hermite blocks x 2x2 bicubic) x 2 levels
TOUCHED_TAPS = {"bilinear": 40, "bspline": 160, "bicubic": 160}


def psih_maker(grid, params):
    """PV inversion: the advecting streamfunction of the RSW state."""
    def psih_fn(sol):
        qh = grid.ik * sol[1] - grid.il * sol[0] - params.f * sol[2]
        return -qh / (grid.Krsq + params.f ** 2 / params.Cg2)
    return psih_fn


def make_case(nx: int, interp: str, table_dtype: str, device):
    """The hero's model, IC, ray parameters and psih_fn on a grid of nx^2."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.coupled.driver import derive_nu
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams

    grid = make_grid(nx, device=device)
    model = rsw.make_model(grid, nu=derive_nu(1.0, nx, 4, DT), nnu=4, f=F, Cg=CG)
    sol0 = band_geo_wave_ic(grid, np.random.default_rng(1), Kg=(10, 13), Kw=(0, 5),
                            ag=0.5, aw=0.05, f=F, Cg=CG)
    rp = RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=interp, table_dtype=table_dtype)
    return grid, model, sol0, rp, psih_maker(grid, model.params)


def phase_environment(card: str) -> None:
    from juliaraytracingsw_tpu_torch.ops import _build

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    if info.commands is None:
        print(f"kernel library reused from an earlier build: {info.path}")
    else:
        print(f"built {info.path.name} in {info.seconds:.2f} s:")
        for cmd in info.commands:
            print(f"  {' '.join(cmd)}")
        for line in info.ptxas_report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"phase 1 (environment) done in {time.perf_counter() - t0:.2f} s")


def phase_kernels(card: str, device, n: int = 1 << 20, nx: int = 512) -> tuple[dict, dict]:
    """Each interp's kernels against their twins at the hero's shapes: rows
    gathered at n random packet positions from the pair table of two hero
    flow fields (the IC of seed 1 as the old level, of seed 2 as the new);
    one substep, and one attempt, of the hero's dt."""
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import Packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import (
        _gather_patch_rows, build_pair, fields_from_psih)

    results, attempts = {}, {}
    for interp in INTERPS:
        grid, _, sol0, rp, psih_fn = make_case(nx, interp, "float32", device)
        sol1 = band_geo_wave_ic(grid, np.random.default_rng(2), Kg=(10, 13), Kw=(0, 5),
                                ag=0.5, aw=0.05, f=F, Cg=CG)
        fo, fn = (fields_from_psih(psih_fn(s), grid, interp) for s in (sol0, sol1))
        T_pair = build_pair(fo, fn, rp)
        del fo, fn
        rng = np.random.default_rng(11)
        x, y = rng.uniform(-grid.Lx / 2, grid.Lx / 2, (2, n)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, n)
        kk = (K0 * np.cos(phase)).astype(np.float32)
        ll = (K0 * np.sin(phase)).astype(np.float32)
        sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0).astype(np.float32)
        p = Packets(*(torch.as_tensor(a, device=device) for a in (x, y, kk, ll, sign)))
        rows, bx, by = _gather_patch_rows(T_pair, p, rp, grid.ny, grid.nx)
        rows_T = rows.t().contiguous()
        del rows, T_pair
        st = torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by])
        cfg = ray_step.substep_cfg(rp, interp)
        scal = torch.tensor([0.0, DT], dtype=torch.float32, device=device)
        results[interp] = compare(
            card, f"kernel {interp}", n, rows_T, TOUCHED_TAPS[interp] + 7 + 4,
            lambda: ray_step.fused_substep(rows_T, st, scal, rp=rp, interp=interp, da=1.0),
            lambda: ray_step.substep_torch(rows_T, st, scal, cfg=cfg, interp=interp,
                                           da=1.0, x0=rp.x0, y0=rp.y0))
        # one attempt of the hero's dt over the whole interval, at the
        # adaptive hero's tolerances; then one where the error row decides
        def attempt(kernel, scal5):
            if kernel:
                return ray_step.fused_attempt(rows_T, st, scal5, rp=rp, interp=interp)
            return ray_step.attempt_torch(rows_T, st, scal5, cfg=cfg, interp=interp,
                                          x0=rp.x0, y0=rp.y0)

        # [a0, dah, h, rtol, atol] on the card before the timed calls
        hero_scal, trunc_scal = (
            torch.tensor([0.0, 1.0, h, rtol, atol], dtype=torch.float32, device=device)
            for h, rtol, atol in ((DT, HERO_ADAPTIVE["rtol"], HERO_ADAPTIVE["atol"]),
                                  (TRUNC_H, TRUNC_TOL, TRUNC_TOL)))
        attempts[interp] = compare(
            card, f"attempt kernel {interp}", n, rows_T, TOUCHED_TAPS[interp] + 7 + 5,
            lambda: attempt(True, hero_scal), lambda: attempt(False, hero_scal))
        error_row(f"attempt kernel {interp}, the hero's dt (round-off, not held)", n,
                  attempt(True, hero_scal), attempt(False, hero_scal), hold=False)
        error_row(f"attempt kernel {interp}, h {TRUNC_H}, rtol = atol = {TRUNC_TOL}", n,
                  attempt(True, trunc_scal), attempt(False, trunc_scal), hold=True)
        del rows_T, st
        torch.cuda.empty_cache()
    return results, attempts


def compare(card: str, what: str, n: int, rows_T, floats_per_packet: int, kernel,
            twin) -> dict:
    """Hold ``kernel()`` against ``twin()`` (rtol KERNEL_RTOL, atol
    KERNEL_ATOL on every row) and time both on the device as the probes are
    timed (``_timing.device_ms``, a CUDA graph); the kernel also eagerly."""
    from juliaraytracingsw_tpu_torch.profiling._timing import bound_ms, device_ms, time_ms

    out, ref = kernel(), twin()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    ms, eager_ms, plain_ms = device_ms(kernel), time_ms(kernel), device_ms(twin)
    gbytes = floats_per_packet * 4 * n / 1e9
    # the least time: the touched taps, the state and the output moved once
    bound = bound_ms(gbytes * 1e9)
    print(f"{what}: N={n}, rows_T {tuple(rows_T.shape)}, max |kernel - twin| = {err:.3e} "
          f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); kernel {ms:.4f} ms ({eager_ms:.4f} ms "
          f"eager), twin {plain_ms:.3f} ms; {gbytes:.3f} GB of touched taps, state and "
          f"output -> {gbytes / ms * 1e3:.0f} GB/s at least, bound {bound:.4f} ms [{card}]")
    # no one PyTorch call computes a substep or an attempt
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None)


def phase_probes(card: str, device) -> tuple[dict, dict]:
    """The probe entry point, every probe at its script's shapes, each
    kernel held bit-equal to its plain version inside; its launches counted
    from 0. Returns (the kernels' rows, the launch counts)."""
    from juliaraytracingsw_tpu_torch import profiling
    from juliaraytracingsw_tpu_torch.ops import probes

    t0 = time.perf_counter()
    probes.reset_launches()
    results = profiling.run_all(device)
    torch.cuda.synchronize()
    counts = dict(probes.launches)
    print(f"phase 2c (probe entry point): {sum(map(len, results.values()))} probes in "
          f"{time.perf_counter() - t0:.2f} s; kernel launches {counts}")
    rows = {}
    for kernel, (module, prefix, _, _) in PROBE_KERNELS.items():
        if counts[kernel] == 0:
            raise AssertionError(f"the probe entry point never launched {kernel}")
        res = next(r for r in results[module] if r.probe.startswith(prefix))
        rows[kernel] = dict(max_abs_err=res.max_abs_err, ms=res.ms, plain_ms=res.plain_ms,
                            bound_ms=res.bound_ms, bound_by="bytes",
                            library_ms=res.library_ms)
    return rows, counts


def error_row(what: str, n: int, out, ref, hold: bool) -> None:
    """The attempt's error row, kernel ``out`` against twin ``ref``: the
    largest esum, the largest difference, and the batch error norm
    sqrt(sum(esum) / 4N) that the step-size controller reads. With ``hold``
    rows 0-3 must agree as in ``compare``, esum to ESUM_ATOL_OF_MAX of its
    largest value and the norm to NORM_RTOL."""
    esum_max = float(ref[4].max())
    esum_err = float((out[4] - ref[4]).abs().max())
    norms = [float(torch.sqrt(o[4].double().sum() / (4 * n))) for o in (out, ref)]
    gap = abs(norms[0] - norms[1]) / norms[1]
    rows_err = float((out[:4] - ref[:4]).abs().max())
    limits = (f" (limits {ESUM_ATOL_OF_MAX} and {NORM_RTOL})" if hold else "")
    print(f"{what}: max esum {esum_max:.4e}, max |kernel - twin| {esum_err:.4e} = "
          f"{esum_err / esum_max:.3e} of it; error norm kernel {norms[0]:.6e}, twin "
          f"{norms[1]:.6e}, relative gap {gap:.3e}{limits}; rows 0-3 max |kernel - twin| "
          f"{rows_err:.3e}")
    if hold:
        torch.testing.assert_close(out[:4], ref[:4], rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        if not (esum_max > 0 and esum_err <= ESUM_ATOL_OF_MAX * esum_max
                and gap <= NORM_RTOL):
            raise AssertionError(f"{what}: the attempt kernel's error row disagrees "
                                 f"with its twin")


def coupled_frame(device, nx: int = 128, sqrtp: int = 128, flow_steps: int = 5,
                  ray_method: str = "rk4", ray_opts: dict | None = None):
    """One coupled frame of the hero's configuration at nx^2 with f32
    tables -> (start packets, end state, the frame's adaptive infos)."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "float32", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    infos = []
    frame = make_coupled_frame(model, step, psih_fn, rp, flow_steps, k_cutoff=K_CUTOFF,
                               k0=K0, ray_method=ray_method, ray_opts=ray_opts,
                               ray_info_fn=infos.append)
    packets = lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    fields = fields_from_psih(psih_fn(sol0), grid, rp.interp)
    end = frame(SimState(sol0, zero_clock(device=device), init(sol0), packets, fields))
    return packets, end, infos


def phase_gpu_vs_cpu(device, ray_method: str = "rk4", ray_opts: dict | None = None) -> None:
    """One 128^2 x 16,384-packet frame on the GPU (the kernel) against the
    CPU (its twin); the GPU frame must launch the kernel once per substep
    (RK4) or attempt (adaptive), and the adaptive frames must take the same
    accept/reject decisions."""
    from juliaraytracingsw_tpu_torch.ops import ray_step

    counts = ray_step.attempt_launches if ray_method == "adaptive" else ray_step.launches
    before = counts["bilinear"]
    _, gpu, gpu_infos = coupled_frame(device, ray_method=ray_method, ray_opts=ray_opts)
    torch.cuda.synchronize()
    launched = counts["bilinear"] - before
    start, cpu, cpu_infos = coupled_frame("cpu", ray_method=ray_method, ray_opts=ray_opts)
    decisions = [[(int(i["n_accepted"]), int(i["n_rejected"])) for i in infos]
                 for infos in (gpu_infos, cpu_infos)]
    expected = sum(a + r for a, r in decisions[0]) if gpu_infos else 5
    if launched != expected:
        raise AssertionError(f"the GPU frame launched the kernel {launched} times, "
                             f"not {expected}")
    if decisions[0] != decisions[1]:
        raise AssertionError(f"accepted/rejected attempts per step differ: GPU "
                             f"{decisions[0]}, CPU {decisions[1]}")
    sol_err = float((gpu.sol.cpu() - cpu.sol).abs().max() / cpu.sol.abs().max())
    pk_err = max(float((getattr(gpu.packets, n).cpu() - getattr(cpu.packets, n)).abs().max())
                 for n in ("x", "y", "k", "l"))
    moved = float((cpu.packets.x - start.x).abs().max())
    steps = f", (accepted, rejected) per step {decisions[0]}" if gpu_infos else ""
    print(f"GPU vs CPU, one {ray_method} coupled frame (128^2, 16384 packets, 5 steps, f32 "
          f"tables): kernel launches {launched}{steps}; sol rel err {sol_err:.3e} "
          f"(limit {FRAME_SOL_RTOL}), packet max abs err {pk_err:.3e} (limit "
          f"{FRAME_PACKET_ATOL}), packets moved up to {moved:.3e}")
    if not (sol_err < FRAME_SOL_RTOL and pk_err < FRAME_PACKET_ATOL and moved > 1e-4):
        raise AssertionError("GPU and CPU frames disagree")


def hero(card: str, device, interp: str, spinup_steps: int, n_frames: int,
         sqrtp: int = 1024, flow_steps: int = 5, ray_method: str = "rk4",
         ray_opts: dict | None = None) -> dict:
    """The hero row ``interp`` through CoupledDriver; returns its numbers."""
    from juliaraytracingsw_tpu_torch.coupled.driver import CoupledDriver
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    tag = interp if ray_method == "rk4" else f"{interp}, {ray_method}"
    marks = []

    def log_fn(line):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        print(f"  [{tag}] {line}")

    drv = CoupledDriver(model=model, psih_fn=psih_fn, rp=rp, dt=DT, stepper="IFMAB3",
                        ray_substeps=1, ray_method=ray_method, ray_opts=ray_opts,
                        k_cutoff=K_CUTOFF, k0=K0, log_fn=log_fn)
    packets = lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    drv.init(sol0, packets)
    e0 = float(rsw.total_energy(drv.sim.sol, grid, model.params))
    res = {}
    if spinup_steps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        drv.spinup(spinup_steps)
        end.record()
        torch.cuda.synchronize()
        res["flow_steps_per_s"] = spinup_steps / (start.elapsed_time(end) / 1e3)
    launches0 = ray_step.launches[interp]
    attempt_launches0 = ray_step.attempt_launches[interp]
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    drv.run(n_frames=n_frames, flow_steps_per_frame=flow_steps)
    torch.cuda.synchronize()
    res["launches"] = ray_step.launches[interp] - launches0
    res["attempt_launches"] = ray_step.attempt_launches[interp] - attempt_launches0
    res["attempts"] = sum(int(i["n_accepted"]) + int(i["n_rejected"])
                          for i in drv.ray_infos)
    res["coupled_steps"] = n_frames * flow_steps
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    steady = frame_ms[1:] or frame_ms     # the first frame warms up
    sim = drv.sim
    kmag = torch.sqrt(sim.packets.k ** 2 + sim.packets.l ** 2)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (sim.sol.abs(), sim.fields, *sim.packets))
    e1 = float(rsw.total_energy(sim.sol, grid, model.params))
    res.update(frame_ms=frame_ms, finite=finite, kmax=float(kmag.max()),
               dE=abs(e1 - e0) / e0,
               coupled_steps_per_s=flow_steps * len(steady) / (sum(steady) / 1e3),
               n=sim.packets.n)
    res["ray_steps_per_s"] = res["coupled_steps_per_s"] * res["n"]
    flow = (f"flow-only spinup {res['flow_steps_per_s']:.1f} steps/s "
            f"({spinup_steps} steps, first call included); " if spinup_steps else "")
    over = (f"over the last {len(steady)} frames" if len(steady) < len(frame_ms)
            else "over 1 frame, first call included")
    if ray_method == "rk4":
        rate = f"{res['ray_steps_per_s']:.4e} ray-steps/s"
        kernel = f"kernel launches {res['launches']}"
    else:
        rate = f"{res['ray_steps_per_s']:.4e} ray-intervals/s"
        kernel = (f"attempt kernel launches {res['attempt_launches']} for "
                  f"{res['attempts']} attempts, RK4 kernel launches {res['launches']}")
    print(f"hero {tag} (512^2 RSW + {res['n']} packets, bf16 tables): {flow}"
          f"{res['coupled_steps_per_s']:.2f} coupled steps/s, {rate} {over} "
          f"(frame ms {', '.join(f'{m:.2f}' for m in frame_ms)}); {kernel}; "
          f"max |k| {res['kmax']:.3f} (cutoff {K_CUTOFF}); energy change "
          f"{res['dE']:.3e}; finite {finite} [{card}]")
    return res


def check_rows(rows: list, interps) -> None:
    for interp, res in zip(interps, rows):
        if not (res["finite"] and res["kmax"] < K_CUTOFF and res["dE"] < 0.01):
            raise AssertionError(f"hero {interp}: finite={res['finite']}, "
                                 f"max|k|={res['kmax']}, dE={res['dE']}")


def adaptive_interval(card: str, device) -> None:
    """Accepted and rejected attempts of one flow interval of the adaptive
    hero, as bench.py:212-224 counts them: the hero's packets through the
    initial condition's fields over one dt."""
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih, raytrace_adaptive

    grid, _, sol0, rp, psih_fn = make_case(512, "bilinear", "bfloat16", device)
    f0 = fields_from_psih(psih_fn(sol0), grid, rp.interp)
    packets = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=f0.device)
    _, info = raytrace_adaptive(packets, f0, f0, 0.0, DT, rp, **HERO_ADAPTIVE)
    print(f"hero adaptive: {int(info['n_accepted'])} accepted / {int(info['n_rejected'])} "
          f"rejected attempts per flow interval (h_final {float(info['h_final']):.6e}) "
          f"[{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.profiling._timing import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()

    phase_environment(card)
    kernels, attempts = phase_kernels(card, device)
    probe_rows, probe_counts = phase_probes(card, device)
    phase_gpu_vs_cpu(device)
    phase_gpu_vs_cpu(device, "adaptive", HERO_ADAPTIVE)

    # the RK4 main path: every launch counted from here on is the hero's
    ray_step.reset_launches()
    main_run = hero(card, device, "bilinear", spinup_steps=200, n_frames=4)
    if main_run["launches"] != 20:
        raise AssertionError(f"hero launched the kernel {main_run['launches']} times, not 20")
    rows = [main_run] + [hero(card, device, interp, spinup_steps=0, n_frames=2)
                         for interp in INTERPS[1:]]
    check_rows(rows, INTERPS)
    counts = dict(ray_step.launches)

    # the adaptive main path: its launches are counted from 0 again
    ray_step.reset_launches()
    ad_main = hero(card, device, "bilinear", spinup_steps=0, n_frames=3,
                   ray_method="adaptive", ray_opts=HERO_ADAPTIVE)
    ad_rows = [ad_main] + [hero(card, device, interp, spinup_steps=0, n_frames=1,
                                ray_method="adaptive", ray_opts=HERO_ADAPTIVE)
                           for interp in INTERPS[1:]]
    check_rows(ad_rows, INTERPS)
    attempt_counts = dict(ray_step.attempt_launches)
    if any(ray_step.launches.values()):
        raise AssertionError(f"the adaptive path launched RK4 kernels: {ray_step.launches}")
    for res in ad_rows:
        # at least one attempt per coupled step, and one launch per attempt
        if not res["attempt_launches"] == res["attempts"] >= res["coupled_steps"]:
            raise AssertionError(f"adaptive hero: {res['attempt_launches']} attempt "
                                 f"launches for {res['attempts']} attempts in "
                                 f"{res['coupled_steps']} coupled steps")
    adaptive_interval(card, device)
    for name, got in (("ray_step", counts), ("ray_attempt", attempt_counts)):
        for interp in INTERPS:
            if got[interp] == 0:
                raise AssertionError(f"the {name} {interp} kernel was not launched by "
                                     f"its main path")

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": f"ray_step_rk4_{interp}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": counts[interp], **kernels[interp]}
        for interp in INTERPS] + [
        {"name": f"ray_attempt_dp5_{interp}", "route": "cuda", "source": ATTEMPT_SOURCE,
         "replaces": ATTEMPT_REPLACES, "launches": attempt_counts[interp],
         **attempts[interp]}
        for interp in INTERPS] + [
        {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
         "launches": probe_counts[kernel], **probe_rows[kernel]}
        for kernel, (_, _, source, replaces) in PROBE_KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
