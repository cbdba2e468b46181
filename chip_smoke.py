"""Drive the PyTorch/CUDA port of juliaraytracingsw_tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them, and on any failed check. Phases, each printing its lines:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the build of the fused RK4 substep kernel (``csrc/ray_step.cu``) by nvcc;
2. the kernel against its plain PyTorch twin at N = 1,048,576 packets for
   each interpolation (bilinear, bspline, bicubic), timed with CUDA events;
3. one coupled frame at 128^2 x 16,384 packets on the GPU (kernel) against
   the same frame on the CPU (twin);
4. the hero through ``CoupledDriver``: 512^2 RSW stepped by IF-AB3, coupled
   to 1,048,576 WKB packets over bfloat16 bilinear patch tables, spun up
   200 flow steps and run 4 frames of 5 coupled steps; then 2 frames each
   of the bspline and bicubic rows of the same path.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
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

# phase 2: kernel vs twin, the same formulas in the same order up to FMA
# contraction
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
# phase 3: GPU vs CPU after 5 coupled steps. cuFFT and the CPU's FFT round
# differently (the port matches the JAX package to 2e-7 of the largest mode
# on the CPU); the packets also see the kernel's FMA contraction.
FRAME_SOL_RTOL = 1e-5
FRAME_PACKET_ATOL = 1e-4
# rows_T values a packet's stages read when they stay in its base cell:
# 5 fields x 2x2 taps (4x4 bspline; 4 Hermite blocks x 2x2 bicubic) x 2 levels
TOUCHED_TAPS = {"bilinear": 40, "bspline": 160, "bicubic": 160}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    if info.command is None:
        print(f"kernel library reused from an earlier build: {info.path}")
    else:
        print(f"built {info.path.name} in {info.seconds:.2f} s: {' '.join(info.command)}")
        for line in info.ptxas_report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"phase 1 (environment) done in {time.perf_counter() - t0:.2f} s")


def phase_kernels(card: str, device, n: int = 1 << 20, nx: int = 512) -> dict:
    """Each interp's kernel against the twin at the hero's shapes: rows
    gathered at n random packet positions from the pair table of two hero
    flow fields (the IC of seed 1 as the old level, of seed 2 as the new),
    one substep of the hero's dt."""
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import Packets
    from juliaraytracingsw_tpu_torch.rays.patch import build_patch_table
    from juliaraytracingsw_tpu_torch.rays.raytrace import (
        _gather_patch_rows, fields_from_psih, make_pair_table)

    results = {}
    for interp in INTERPS:
        grid, _, sol0, rp, psih_fn = make_case(nx, interp, "float32", device)
        sol1 = band_geo_wave_ic(grid, np.random.default_rng(2), Kg=(10, 13), Kw=(0, 5),
                                ag=0.5, aw=0.05, f=F, Cg=CG)
        fo, fn = (fields_from_psih(psih_fn(s), grid, interp) for s in (sol0, sol1))
        T_pair = make_pair_table(build_patch_table(fo, interp),
                                 build_patch_table(fn, interp))
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
        scal = torch.tensor([0.0, DT], dtype=torch.float32, device=device)
        cfg = ray_step.substep_cfg(rp, interp)

        def kernel():
            return ray_step.fused_substep(rows_T, st, scal, rp=rp, interp=interp, da=1.0)

        def twin():
            return ray_step.substep_torch(rows_T, st, scal, cfg=cfg, interp=interp,
                                          da=1.0, x0=rp.x0, y0=rp.y0)

        out, ref = kernel(), twin()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        ms = cuda_ms(kernel, warmup=3, iters=20)
        plain_ms = cuda_ms(twin, warmup=1, iters=3)
        gbytes = (TOUCHED_TAPS[interp] + 7 + 4) * 4 * n / 1e9
        results[interp] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"kernel {interp}: N={n}, rows_T {tuple(rows_T.shape)}, max |kernel - twin| "
              f"= {err:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); kernel {ms:.4f} ms, "
              f"twin {plain_ms:.3f} ms; {gbytes:.3f} GB of touched taps, state and "
              f"output -> {gbytes / ms * 1e3:.0f} GB/s at least [{card}]")
        del rows_T, st, out, ref
        torch.cuda.empty_cache()
    return results


def coupled_frame(device, nx: int = 128, sqrtp: int = 128, flow_steps: int = 5):
    """One coupled frame of the hero's configuration at nx^2 with f32 tables."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "float32", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    frame = make_coupled_frame(model, step, psih_fn, rp, flow_steps,
                               k_cutoff=K_CUTOFF, k0=K0)
    packets = lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    fields = fields_from_psih(psih_fn(sol0), grid, rp.interp)
    return packets, frame(SimState(sol0, zero_clock(device=device), init(sol0),
                                   packets, fields))


def phase_gpu_vs_cpu(device) -> None:
    from juliaraytracingsw_tpu_torch.ops import ray_step

    before = ray_step.launches["bilinear"]
    _, gpu = coupled_frame(device)
    torch.cuda.synchronize()
    if ray_step.launches["bilinear"] != before + 5:
        raise AssertionError(f"the GPU frame did not launch the kernel 5 times: "
                             f"{ray_step.launches}")
    start, cpu = coupled_frame("cpu")
    sol_err = float((gpu.sol.cpu() - cpu.sol).abs().max() / cpu.sol.abs().max())
    pk_err = max(float((getattr(gpu.packets, n).cpu() - getattr(cpu.packets, n)).abs().max())
                 for n in ("x", "y", "k", "l"))
    moved = float((cpu.packets.x - start.x).abs().max())
    print(f"GPU vs CPU, one coupled frame (128^2, 16384 packets, 5 steps, f32 tables): "
          f"sol rel err {sol_err:.3e} (limit {FRAME_SOL_RTOL}), packet max abs err "
          f"{pk_err:.3e} (limit {FRAME_PACKET_ATOL}), packets moved up to {moved:.3e}")
    if not (sol_err < FRAME_SOL_RTOL and pk_err < FRAME_PACKET_ATOL and moved > 1e-4):
        raise AssertionError("GPU and CPU frames disagree")


def hero(card: str, device, interp: str, spinup_steps: int, n_frames: int,
         sqrtp: int = 1024, flow_steps: int = 5) -> dict:
    """The hero row ``interp`` through CoupledDriver; returns its numbers."""
    from juliaraytracingsw_tpu_torch.coupled.driver import CoupledDriver
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    marks = []

    def log_fn(line):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        print(f"  [{interp}] {line}")

    drv = CoupledDriver(model=model, psih_fn=psih_fn, rp=rp, dt=DT, stepper="IFMAB3",
                        ray_substeps=1, k_cutoff=K_CUTOFF, k0=K0, log_fn=log_fn)
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
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    drv.run(n_frames=n_frames, flow_steps_per_frame=flow_steps)
    torch.cuda.synchronize()
    res["launches"] = ray_step.launches[interp] - launches0
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    steady = frame_ms[1:]                     # the first frame warms up
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
    print(f"hero {interp} (512^2 RSW + {res['n']} packets, bf16 tables): {flow}"
          f"{res['coupled_steps_per_s']:.2f} coupled steps/s, "
          f"{res['ray_steps_per_s']:.4e} ray-steps/s over the last {len(steady)} frames "
          f"(frame ms {', '.join(f'{m:.2f}' for m in frame_ms)}); kernel launches "
          f"{res['launches']}; max |k| {res['kmax']:.3f} (cutoff {K_CUTOFF}); "
          f"energy change {res['dE']:.3e}; finite {finite} [{card}]")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from juliaraytracingsw_tpu_torch.ops import ray_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()

    phase_environment(card)
    kernels = phase_kernels(card, device)
    phase_gpu_vs_cpu(device)

    # the main path: every launch counted from here on is the hero's
    ray_step.reset_launches()
    main_run = hero(card, device, "bilinear", spinup_steps=200, n_frames=4)
    if main_run["launches"] != 20:
        raise AssertionError(f"hero launched the kernel {main_run['launches']} times, not 20")
    rows = [main_run] + [hero(card, device, interp, spinup_steps=0, n_frames=2)
                         for interp in INTERPS[1:]]
    counts = dict(ray_step.launches)
    for interp, res in zip(INTERPS, rows):
        if not (res["finite"] and res["kmax"] < K_CUTOFF and res["dE"] < 0.01):
            raise AssertionError(f"hero {interp}: finite={res['finite']}, "
                                 f"max|k|={res['kmax']}, dE={res['dE']}")
        if counts[interp] == 0:
            raise AssertionError(f"the {interp} kernel was not launched by the main path")

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": f"ray_step_rk4_{interp}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": counts[interp], **kernels[interp]}
        for interp in INTERPS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
