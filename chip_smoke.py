"""Drive the PyTorch/CUDA port of juliaraytracingsw_tpu once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them, and on any failed check. Phases, each printing its lines:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the build of the kernels (``csrc/ray_step.cu``, the fused RK4 substep,
   ``csrc/ray_attempt.cu``, the fused DP5(4) attempt, each in its first cut
   and its table form, ``csrc/pair_table.cu``, the pair table, and the
   probe kernels' three sources) by nvcc, one process per source;
2. the RK4 kernel against its plain PyTorch twin at N = 1,048,576 packets
   for each interpolation (bilinear, bspline, bicubic): the first cut on
   rows gathered from the float32 table, the table form reading the
   float32 and the bfloat16 table itself, held also against the first cut
   on the rows the ray path gathers, each timed on the device in a CUDA
   graph, as the probes are, the table form beside the whole first-cut
   path (gather, upcast, transpose, kernel); 2b. the same for the attempt
   kernel, whose error row is also held at a step where the truncation
   error is far above round-off;
2c. the probe entry point (``juliaraytracingsw_tpu_torch.profiling``, the
   port of the Pallas probe scripts in ``benchmarks/profiling/``): every
   probe at its script's shapes through the copy and gather kernels
   (``csrc/probe_copy.cu``, ``csrc/probe_gather.cu``,
   ``csrc/probe_row_ring.cu``), each held bit-equal to its plain version
   and timed beside its bound and its PyTorch library call;
2d. the pair-table kernel (``ops/pair_table``) against its twin, the roll
   path run on the card, at 512^2 for each interp and table dtype:
   bit-equal, both timed in a CUDA graph beside the kernel's byte bound
   (both stacks read, the table written once);
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
   bspline and bicubic rows;
5. gradients on the card: 5a. ``TableSubstep``'s backward (the per-stage
   formulation in plain PyTorch, as the reference's is XLA) at N =
   1,048,576 for each interp on the float32 and the bfloat16 table, held
   against plain autograd through the twin, forward + backward timed in a
   CUDA graph beside the forward alone; 5b. the gradient of mean(k^2 +
   l^2) with respect to sol through one 128^2 RK4 frame, GPU vs CPU, and
   one implicit-midpoint frame GPU vs CPU (forward); 5c. the hero's fwd+bwd
   step (``bench.py:324-341``), one table kernel launch a call, timed with
   its peak memory; 5d. the gradient through 100 coupled 512^2 steps with
   remat (``bench.py:343-376``, taps gather, 16,384 packets), timed with
   its peak memory, and 10 steps with and without remat, held equal;
6. the command line on the card (``juliaraytracingsw_tpu_torch.experiments``):
   6a. the RK4 hero through ``rsw ... --gather auto --checkpoint``: 'auto'
   resolves to patch, the table kernel runs 20 times and the first cut
   never, the HDF5 outputs hold 4 packet frames and 4 snapshots,
   diagnostics are finite, energy changes by less than 1%, |k| < k_cutoff;
   coupled steps/s over the last 3 frames with the writers and without,
   beside phase 4's. Where h5py is not installed the command line cannot
   write: the same path then runs through ``CoupledDriver`` built by the
   command line's own setup, without writers, and once more with the packet
   telemetry copied to the host and dropped, and a line says so;
   6b. bit-exact resume at hero size: checkpoint after 2 frames, 2 more
   frames, a fresh driver restored from the checkpoint runs the same 2;
   6c. 6a's checkpoint restored into a driver on the CPU, every leaf equal;
   6d. one small run (128^2, 16,384 packets, patch) on the card and on the
   CPU: diagnostics within rtol 1e-5, the last packets within 1e-4;
7. the other flow models, each case through the command line's set-up
   without writers: 7a. ``bench.py:282-310``'s 2048^2 two-layer flow, 40
   IF-AB3 steps timed, the host seconds of its expm tables; 7b. ``twolayer``
   at 2048^2 x 262,144 packets ('auto' -> taps); 7c. at 512^2 x 1,048,576
   ('auto' -> patch, exactly 20 table kernel runs), barotropic and
   ``--baroclinic``; 7d. 3 layers, 512^2 x 262,144, one frame; 7e.
   Thomas-Yamada 512^2, ETDRK4, a startup and a main phase through
   ``ty_driver._phase``, the host seconds of its contour coefficients;
   7f. ``rsw --model linborg|modified|quadheight`` at the hero's size, one
   frame each; 7g. each new path on the card against the CPU, held as
   phase 3 holds a frame;
8. Weibull birth/death and the other new paths: 8a. the birth/death
   kernel (``csrc/birth_death.cu``) against its twin at 262,144 and
   1,048,576 packets over 3 chained calls, bit-equal but lifetimes (1
   ulp), the twin on the card bit-equal to the twin on the CPU, each timed
   beside its byte bound; 8b. hero_bd (``bench.py:202``): 512^2 RSW,
   262,144 packets, bilinear bf16 tables, RK4, Weibull(1.5, 10) seeded 0,
   4 frames of 5 steps, exactly 20 table and 20 birth/death kernel runs,
   births within 5 sigma of N T E[1/L]; 8c. its JAX-format checkpoint
   restored on the CPU, the next frame's population bit-equal; 8d.
   ``steady-raytracing`` through the command line at 512^2 x 1,048,576
   ('auto' -> patch, 2 frames of 20 substeps, exactly 40 table launches);
   8e. a birth/death frame, ``nufft_raytrace``, ``raytrace1d`` and forced
   RSW steps on the card against the CPU, and ``benchmark_integrators``;
9. ``parallel/`` on a mesh of one process over NCCL (``make_mesh``: a
   world-size-1 group on a ``FileStore``; NCCL refuses two ranks on one
   card, so the multi-rank checks are the CPU tests'): 9a. the slab FFT
   of a (7, 512, 512) field against ``torch.fft`` to 1e-5, its round trip
   to 1e-5, one ``all_to_all`` a transform, both timed; 9b.
   hero_sharded1 (``bench.py:226-254``): ``ShardedRSW`` at 512^2, IF-AB3,
   1,048,576 packets, bilinear bf16 tables, phase 4's IC spun up 200
   sharded steps, 4 frames of 5 coupled steps, exactly 20 table launches
   and no first cut, the first frame held against the replicated frame
   from the same state (the JAX tests' limits), every frame finite, |k| <
   k_cutoff, energy within 1%; ray-steps/s over the last 3 frames and
   ``hero_sharded1_vs_replicated`` (phase 4's of this run); 9c.
   ``overlap=True`` against the sequential frame at 9b's size; 9d. the
   command line's ``--sharded`` path without writers: ``rsw`` at 128^2 x
   16,384, 2 frames, its checkpoint restored on the CPU by the replicated
   port (the next frame within phase 3's limits), ``twolayer`` at 256^2
   with taps and ``thomasyamada`` at 128^2 against the replicated port on
   the card.

The kernels' launch counts are set to 0 before each main path (2c, 4, 4b,
5c, 6a, each coupled case of phase 7, 8b, 8d, 9b and 9d) and read after
it; the heroes must launch only the table forms, and build one pair table
a coupled step (phases 4, 4b). The wrappers' counters
count the host's launches, and ``CoupledDriver`` replays its frames as
CUDA graphs, which run their kernels with none: on the paths through it
(4, 4b, 6a, the coupled cases of phase 7, 8b) the ray and birth/death
kernels' runs on the card are counted from a ``torch.profiler`` trace of
the run (``kernel_runs``), graph replays included, and the counters show
that no other interp's kernel launched. The first cut runs on no main
path: its launches are phase 2's. Every time printed carries the card's
name and power limit.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

F, CG, DT = 3.0, 1.0, 1e-3          # the hero's f, Cg and flow dt
K0 = float(np.sqrt(3.0) * F / CG)
K_CUTOFF = 100.0 * F / CG
INTERPS = ("bilinear", "bspline", "bicubic")
TABLE_DTYPES = ("float32", "bfloat16")
KERNEL_SOURCE = "juliaraytracingsw_tpu_torch/csrc/ray_step.cu"
REPLACES = "juliaraytracingsw_tpu/ops/pallas_ray_step.py:284"
ATTEMPT_SOURCE = "juliaraytracingsw_tpu_torch/csrc/ray_attempt.cu"
ATTEMPT_REPLACES = "juliaraytracingsw_tpu/ops/pallas_ray_step.py:462"
PAIR_SOURCE = "juliaraytracingsw_tpu_torch/csrc/pair_table.cu"
PAIR_REPLACES = ("juliaraytracingsw_tpu/rays/patch.py:91 (build_pair_table_direct), "
                 "juliaraytracingsw_tpu/rays/raytrace.py:198 (build_pair's roll path)")
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
# phase 5a: TableSubstep's backward (the per-stage formulation) against
# plain autograd through the twin, both on the card: two formulations of
# one VJP in float32, the state's and the scalars' cotangents to rtol 1e-4,
# atol 1e-6 of their largest; the table's cotangent is summed by atomics
# in no fixed order, the float32 table's to 1e-4 of its largest (the
# bfloat16 table's accumulates in bfloat16: finite, the same rows reached)
SUBSTEP_VJP_RTOL, SUBSTEP_VJP_ATOL_OF_MAX = 1e-4, 1e-6
TABLE_VJP_ATOL_OF_MAX = 1e-4
# phase 5b: the frame's gradient GPU vs CPU, relative L2 (cuFFT against the
# CPU's FFT, FMA contraction in the kernel, atomics in the scatters)
GRAD_L2_RTOL = 1e-4
# phase 5d: the 10-step gradient with and without remat, max |difference|
# over max |gradient| (the recomputed steps are the same calls; only the
# atomics' order differs)
REMAT_RTOL = 1e-6
# phase 6d: a 128^2 run of 120 steps through the command line, GPU vs CPU,
# held as phase 3 holds one frame: diagnostics to rtol 1e-5, packets to 1e-4
CLI_DIAG_RTOL = 1e-5


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


def phase_kernels(card: str, device, n: int = 1 << 20, nx: int = 512) -> tuple[dict, ...]:
    """Each interp's kernels against their twins at the hero's shapes: n
    random packet positions over the pair table of two hero flow fields
    (the IC of seed 1 as the old level, of seed 2 as the new); one substep,
    and one attempt, of the hero's dt. The first cut runs on the rows
    gathered from the float32 table; the table forms read the float32 and
    the bfloat16 table themselves, each held against its twin and against
    the first cut on the rows the ray path would have gathered, and timed
    beside that whole first-cut path (gather, upcast, transpose, kernel)."""
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.profiling._timing import unique_rows
    from juliaraytracingsw_tpu_torch.rays.raytrace import build_pair, fields_from_psih

    results, attempts, tables, table_attempts = {}, {}, {}, {}
    for interp in INTERPS:
        grid, _, sol0, rp, psih_fn = make_case(nx, interp, "float32", device)
        ny = grid.ny
        sol1 = band_geo_wave_ic(grid, np.random.default_rng(2), Kg=(10, 13), Kw=(0, 5),
                                ag=0.5, aw=0.05, f=F, Cg=CG)
        fo, fn = (fields_from_psih(psih_fn(s), grid, interp) for s in (sol0, sol1))
        pairs = {dtype: build_pair(fo, fn, rp._replace(table_dtype=dtype))
                 for dtype in TABLE_DTYPES}
        del fo, fn
        rng = np.random.default_rng(11)
        x, y = rng.uniform(-grid.Lx / 2, grid.Lx / 2, (2, n)).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, n)
        kk = (K0 * np.cos(phase)).astype(np.float32)
        ll = (K0 * np.sin(phase)).astype(np.float32)
        sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0).astype(np.float32)
        st = torch.as_tensor(np.stack([x, y, kk, ll, sign]), device=device)
        rows_T, st7 = ray_step.first_cut_inputs(pairs["float32"], st, rp, ny, grid.nx)
        cells = (torch.remainder(st7[6].to(torch.int32), ny) * grid.nx
                 + torch.remainder(st7[5].to(torch.int32), grid.nx))
        held_rows = unique_rows(cells)
        cfg = ray_step.substep_cfg(rp, interp)
        scal = torch.tensor([0.0, DT], dtype=torch.float32, device=device)
        # the first cut: the touched taps, the state and the output moved once
        results[interp] = compare(
            card, f"kernel {interp}, rows_T {tuple(rows_T.shape)}", n,
            (TOUCHED_TAPS[interp] + 7 + 4) * 4 * n,
            lambda: ray_step.fused_substep(rows_T, st7, scal, rp=rp, interp=interp, da=1.0),
            lambda: ray_step.substep_torch(rows_T, st7, scal, cfg=cfg, interp=interp,
                                           da=1.0, x0=rp.x0, y0=rp.y0))
        # one attempt of the hero's dt over the whole interval, at the
        # adaptive hero's tolerances; then one where the error row decides
        # ([a0, dah, h, rtol, atol] on the card before the timed calls)
        hero_scal, trunc_scal = (
            torch.tensor([0.0, 1.0, h, rtol, atol], dtype=torch.float32, device=device)
            for h, rtol, atol in ((DT, HERO_ADAPTIVE["rtol"], HERO_ADAPTIVE["atol"]),
                                  (TRUNC_H, TRUNC_TOL, TRUNC_TOL)))

        def attempt(kernel, scal5):
            if kernel:
                return ray_step.fused_attempt(rows_T, st7, scal5, rp=rp, interp=interp)
            return ray_step.attempt_torch(rows_T, st7, scal5, cfg=cfg, interp=interp,
                                          x0=rp.x0, y0=rp.y0)

        attempts[interp] = compare(
            card, f"attempt kernel {interp}, rows_T {tuple(rows_T.shape)}", n,
            (TOUCHED_TAPS[interp] + 7 + 5) * 4 * n,
            lambda: attempt(True, hero_scal), lambda: attempt(False, hero_scal))
        error_row(f"attempt kernel {interp}, the hero's dt (round-off, not held)", n,
                  attempt(True, hero_scal), attempt(False, hero_scal), hold=False)
        error_row(f"attempt kernel {interp}, h {TRUNC_H}, rtol = atol = {TRUNC_TOL}", n,
                  attempt(True, trunc_scal), attempt(False, trunc_scal), hold=True)
        del rows_T, st7

        # the table forms, over each table dtype
        for dtype, T_pair in pairs.items():
            rpd = rp._replace(table_dtype=dtype)
            geo = dict(ny=ny, nx=grid.nx)
            # the table rows that hold a packet, read once, the state and
            # the output
            row_bytes = held_rows * T_pair.shape[1] * T_pair.element_size()
            sub = dict(rp=rpd, interp=interp, da=1.0)
            tables[interp, dtype] = compare_table(
                card, f"table kernel {interp}, {dtype} table {tuple(T_pair.shape)}", n,
                row_bytes + (5 + 4) * 4 * n,
                lambda: ray_step.table_substep(T_pair, st, scal, **sub, **geo),
                lambda: ray_step.table_substep_torch(T_pair, st, scal, **sub, **geo),
                lambda: ray_step.fused_substep(
                    *ray_step.first_cut_inputs(T_pair, st, rpd, ny, grid.nx), scal, **sub))

            def table_attempt(kernel, scal5):
                fn = ray_step.table_attempt if kernel else ray_step.table_attempt_torch
                return fn(T_pair, st, scal5, rp=rpd, interp=interp, **geo)

            table_attempts[interp, dtype] = compare_table(
                card, f"table attempt kernel {interp}, {dtype} table {tuple(T_pair.shape)}", n,
                row_bytes + (5 + 5) * 4 * n,
                lambda: table_attempt(True, hero_scal), lambda: table_attempt(False, hero_scal),
                lambda: ray_step.fused_attempt(
                    *ray_step.first_cut_inputs(T_pair, st, rpd, ny, grid.nx), hero_scal, rp=rpd,
                    interp=interp))
            error_row(f"table attempt kernel {interp}, {dtype} table, h {TRUNC_H}, rtol = "
                      f"atol = {TRUNC_TOL}", n, table_attempt(True, trunc_scal),
                      table_attempt(False, trunc_scal), hold=True)
        del pairs, st
        torch.cuda.empty_cache()
    return results, attempts, tables, table_attempts


def phase_pair_table(card: str, device, ny: int = 512, nx: int = 512) -> dict:
    """2d: the pair-table kernel (``ops/pair_table``) against its twin, the
    roll path, run on the card, for each interp and table dtype at the
    hero's grid: bit-equal, both timed in a CUDA graph. The bound reads both
    (NCH, ny, nx) float32 stacks and writes the table once; no one PyTorch
    call builds it."""
    from juliaraytracingsw_tpu_torch.ops import pair_table as pt
    from juliaraytracingsw_tpu_torch.ops.ray_step import n_channels
    from juliaraytracingsw_tpu_torch.profiling._timing import bound_ms, device_ms, time_ms

    rows = {}
    rng = np.random.default_rng(5)
    for interp in INTERPS:
        fo, fn = (torch.as_tensor(rng.standard_normal((n_channels(interp), ny, nx))
                                  .astype(np.float32), device=device) for _ in range(2))
        for dtype in TABLE_DTYPES:
            def kernel():
                return pt.pair_table(fo, fn, interp=interp, table_dtype=dtype)

            def twin():
                return pt.pair_table_torch(fo, fn, interp, dtype)

            out, ref = kernel(), twin()
            torch.cuda.synchronize()
            bits = torch.int16 if out.dtype == torch.bfloat16 else torch.int32
            equal = out.shape == ref.shape and torch.equal(out.view(bits), ref.view(bits))
            if not equal:
                raise AssertionError(f"2d: pair table {interp} {dtype} differs from its twin")
            nbytes = 2 * fo.numel() * 4 + out.numel() * out.element_size()
            shape = tuple(out.shape)
            del out, ref
            ms, eager_ms, plain_ms = device_ms(kernel), time_ms(kernel), device_ms(twin)
            bound = bound_ms(nbytes)
            print(f"pair table kernel {interp}, {dtype} table {shape}, bit-equal to the "
                  f"twin: {ms:.4f} ms ({eager_ms:.4f} ms eager), twin {plain_ms:.4f} ms "
                  f"({plain_ms / ms:.1f}x); {nbytes / 1e6:.1f} MB at least -> "
                  f"{nbytes / 1e6 / ms:.0f} GB/s, bound {bound:.4f} ms ({100 * bound / ms:.1f}% "
                  f"of it) [{card}]", flush=True)
            rows[interp, dtype] = dict(max_abs_err=0.0, bit_equal=True, ms=ms, eager_ms=eager_ms,
                                       plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                                       library_ms=None)
        del fo, fn
        torch.cuda.empty_cache()
    return rows


def compare(card: str, what: str, n: int, nbytes: float, kernel, twin) -> dict:
    """Hold ``kernel()`` against ``twin()`` (rtol KERNEL_RTOL, atol
    KERNEL_ATOL on every row) and time both on the device as the probes are
    timed (``_timing.device_ms``, a CUDA graph); the kernel also eagerly.
    ``nbytes``: the least the function must move, for its bound."""
    from juliaraytracingsw_tpu_torch.profiling._timing import bound_ms, device_ms, time_ms

    out, ref = kernel(), twin()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    ms, eager_ms, plain_ms = device_ms(kernel), time_ms(kernel), device_ms(twin)
    bound = bound_ms(nbytes)
    print(f"{what}: N={n}, max |kernel - twin| = {err:.3e} (rtol {KERNEL_RTOL}, atol "
          f"{KERNEL_ATOL}); kernel {ms:.4f} ms ({eager_ms:.4f} ms eager), twin "
          f"{plain_ms:.3f} ms; {nbytes / 1e9:.4f} GB at least -> {nbytes / 1e6 / ms:.0f} GB/s, "
          f"bound {bound:.4f} ms [{card}]")
    # no one PyTorch call computes a substep or an attempt
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None)


def compare_table(card: str, what: str, n: int, nbytes: float, kernel, twin,
                  first_cut) -> dict:
    """``compare`` for a table kernel, and then against ``first_cut()``, the
    path it replaces (gather, upcast, transpose, first-cut kernel): the
    largest difference (bit-equal expected: the bf16 upcast is exact and the
    stage code is the same; held to the kernel tolerance) and that whole
    path's time in one CUDA graph."""
    from juliaraytracingsw_tpu_torch.profiling._timing import device_ms

    res = compare(card, what, n, nbytes, kernel, twin)
    out, ref = kernel(), first_cut()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    first_ms = device_ms(first_cut)
    print(f"  {what}: max |table kernel - first cut| = {err:.3e} (bit-equal "
          f"{torch.equal(out, ref)}); first-cut path (gather, upcast, transpose, kernel) "
          f"{first_ms:.4f} ms, {first_ms / res['ms']:.1f}x the table kernel [{card}]")
    return dict(res, max_abs_err_first_cut=err, first_cut_ms=first_ms)


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
                  ray_method: str = "rk4", ray_opts: dict | None = None,
                  birth_death: dict | None = None):
    """One coupled frame of the hero's configuration at nx^2 with f32
    tables (with ``birth_death`` = dict(k_shape=, lam=), the ensemble
    resampled from ``init_birth_death(prng_key(0))``) -> (start packets,
    end state, the frame's adaptive infos)."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.prng import prng_key
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih
    from juliaraytracingsw_tpu_torch.rays.resample import init_birth_death

    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "float32", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    infos = []
    frame = make_coupled_frame(model, step, psih_fn, rp, flow_steps, k_cutoff=K_CUTOFF,
                               k0=K0, ray_method=ray_method, ray_opts=ray_opts,
                               ray_info_fn=infos.append, birth_death=birth_death)
    packets = lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    fields = fields_from_psih(psih_fn(sol0), grid, rp.interp)
    bd = (init_birth_death(prng_key(0, device=device), packets.n, **birth_death)
          if birth_death else None)
    end = frame(SimState(sol0, zero_clock(device=device), init(sol0), packets, fields, bd))
    return packets, end, infos


def phase_gpu_vs_cpu(device, ray_method: str = "rk4", ray_opts: dict | None = None) -> None:
    """One 128^2 x 16,384-packet frame on the GPU (the kernel) against the
    CPU (its twin); the GPU frame must launch the table kernel once per
    substep (RK4) or attempt (adaptive) and no first-cut kernel, and the
    adaptive frames must take the same accept/reject decisions."""
    from juliaraytracingsw_tpu_torch.ops import ray_step

    counts = (ray_step.table_attempt_launches if ray_method == "adaptive"
              else ray_step.table_launches)
    before = counts["bilinear"]
    first_cut = launch_counts()["first cut"]
    _, gpu, gpu_infos = coupled_frame(device, ray_method=ray_method, ray_opts=ray_opts)
    torch.cuda.synchronize()
    launched = counts["bilinear"] - before
    if launch_counts()["first cut"] != first_cut:
        raise AssertionError("the GPU frame launched a first-cut (rows_T) kernel")
    start, cpu, cpu_infos = coupled_frame("cpu", ray_method=ray_method, ray_opts=ray_opts)
    decisions = [[(int(i["n_accepted"]), int(i["n_rejected"])) for i in infos]
                 for infos in (gpu_infos, cpu_infos)]
    # one launch per attempt (adaptive) or RK4 substep; midpoint runs per stage
    expected = (sum(a + r for a, r in decisions[0]) if gpu_infos
                else 5 if ray_method == "rk4" else 0)
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
         ray_opts: dict | None = None, driver_kw: dict | None = None,
         tag: str | None = None, nx: int = 512) -> tuple[dict, object]:
    """The hero row ``interp`` through CoupledDriver (``driver_kw``: more
    of its options) -> (its numbers, the driver)."""
    from juliaraytracingsw_tpu_torch.coupled.driver import CoupledDriver
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    grid, model, sol0, rp, psih_fn = make_case(nx, interp, "bfloat16", device)
    tag = tag or (interp if ray_method == "rk4" else f"{interp}, {ray_method}")
    marks = []

    def log_fn(line):
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        print(f"  [{tag}] {line}")

    drv = CoupledDriver(model=model, psih_fn=psih_fn, rp=rp, dt=DT, stepper="IFMAB3",
                        ray_substeps=1, ray_method=ray_method, ray_opts=ray_opts,
                        k_cutoff=K_CUTOFF, k0=K0, log_fn=log_fn, **(driver_kw or {}))
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
    others0 = {k: v for k, v in launch_counts()["table"].items() if k != interp}
    with kernel_runs() as runs:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        drv.run(n_frames=n_frames, flow_steps_per_frame=flow_steps)
    if {k: v for k, v in launch_counts()["table"].items() if k != interp} != others0:
        raise AssertionError(f"hero {tag}: another interp's table kernel launched")
    res["launches"] = runs["table"]
    res["attempt_launches"] = runs["table attempt"]
    res["first_cut_launches"] = runs["first cut"]
    res["bd_launches"] = runs["birth_death"]
    res["pair_table_runs"] = runs["pair table"]
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
        kernel = f"table kernel runs {res['launches']}"
    else:
        rate = f"{res['ray_steps_per_s']:.4e} ray-intervals/s"
        kernel = (f"table attempt kernel runs {res['attempt_launches']} for "
                  f"{res['attempts']} attempts, RK4 table kernel runs {res['launches']}")
    kernel += f", first-cut (rows_T) kernel runs {res['first_cut_launches']}"
    print(f"hero {tag} ({nx}^2 RSW + {res['n']} packets, bf16 tables): {flow}"
          f"{res['coupled_steps_per_s']:.2f} coupled steps/s, {rate} {over} "
          f"(frame ms {', '.join(f'{m:.2f}' for m in frame_ms)}); {kernel}; "
          f"max |k| {res['kmax']:.3f} (cutoff {K_CUTOFF}); energy change "
          f"{res['dE']:.3e}; finite {finite} [{card}]")
    return res, drv


def launch_counts() -> dict:
    """The ray kernels' launch counts: each table form's, and the first
    cut's (both first-cut kernels summed over interps)."""
    from juliaraytracingsw_tpu_torch.ops import ray_step

    return {"table": dict(ray_step.table_launches),
            "table attempt": dict(ray_step.table_attempt_launches),
            "first cut": sum(ray_step.launches.values()) + sum(ray_step.attempt_launches.values())}


# the hand-written kernels by the names they run under on the card
KERNEL_NAMES = {"table": ("ray_step_table_kernel",),
                "pair table": ("pair_table_kernel",),
                "table attempt": ("ray_attempt_table_kernel",),
                "first cut": ("ray_step_kernel", "ray_attempt_kernel"),
                "birth_death": ("birth_death_kernel",)}


@contextlib.contextmanager
def kernel_runs():
    """``with kernel_runs() as runs: ...``: the ray and birth/death
    kernels' runs on the card inside the block, CUDA graph replays
    included, from a ``torch.profiler`` trace; ``runs`` holds them by the
    keys of ``KERNEL_NAMES`` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    runs: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield runs
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    for key, subs in KERNEL_NAMES.items():
        runs[key] = sum(1 for n in names if any(sub in n for sub in subs))


def check_rows(rows: list, interps) -> None:
    for interp, res in zip(interps, rows):
        if not (res["finite"] and res["kmax"] < K_CUTOFF and res["dE"] < 0.01):
            raise AssertionError(f"hero {interp}: finite={res['finite']}, "
                                 f"max|k|={res['kmax']}, dE={res['dE']}")
        if res["first_cut_launches"]:
            raise AssertionError(f"hero {interp} launched {res['first_cut_launches']} "
                                 f"first-cut (rows_T) kernels")


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


def substep_vjp(fn, T_pair, st, scal, cot, **geo):
    """Cotangents of (T_pair, st, scal) of ``fn`` (``table_substep`` or its
    twin) at the output cotangent ``cot``."""
    leaves = [t.detach().requires_grad_() for t in (T_pair, st, scal)]
    return torch.autograd.grad(fn(*leaves, **geo), leaves, cot)


def phase_substep_backward(card: str, device, n: int = 1 << 20, nx: int = 512) -> dict:
    """5a: ``TableSubstep``'s backward (the per-stage formulation, plain
    PyTorch) at the hero's shapes, for each interp on the float32 and the
    bfloat16 table, against plain autograd through the twin on the card;
    forward + backward timed in a CUDA graph beside the forward alone.
    Returns {(interp, dtype): forward + backward ms}."""
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.profiling._timing import device_ms
    from juliaraytracingsw_tpu_torch.rays.raytrace import build_pair, fields_from_psih

    times = {}
    for interp in INTERPS:
        grid, _, sol0, rp, psih_fn = make_case(nx, interp, "float32", device)
        sol1 = band_geo_wave_ic(grid, np.random.default_rng(2), Kg=(10, 13), Kw=(0, 5),
                                ag=0.5, aw=0.05, f=F, Cg=CG)
        fo, fn = (fields_from_psih(psih_fn(s), grid, interp) for s in (sol0, sol1))
        # packets in random cells, 0.2 cells or more from any face: over one
        # hero dt no stage comes near one. At a face the bilinear
        # interpolant's derivative jumps, and the kernel's patch-local and
        # the per-stage formulation's global coordinates may round a stage
        # there to either side (seen on the card: 96 of 5,242,880 state
        # cotangents of random positions)
        rng = np.random.default_rng(12)
        cx, cy = rng.integers(0, nx, (2, n))
        x, y = (origin + (c + rng.uniform(0.2, 0.8, n)) * step
                for origin, c, step in ((rp.x0, cx, rp.dx), (rp.y0, cy, rp.dy)))
        phase = rng.uniform(0, 2 * np.pi, n)
        sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
        st = torch.as_tensor(np.stack([x, y, K0 * np.cos(phase), K0 * np.sin(phase), sign])
                             .astype(np.float32), device=device)
        cot = torch.as_tensor(rng.standard_normal((4, n)).astype(np.float32), device=device)
        scal = torch.tensor([0.0, DT], dtype=torch.float32, device=device)
        for dtype in TABLE_DTYPES:
            rpd = rp._replace(table_dtype=dtype)
            T_pair = build_pair(fo, fn, rpd)
            geo = dict(rp=rpd, interp=interp, da=1.0, ny=grid.ny, nx=grid.nx)
            ref = substep_vjp(ray_step.table_substep_torch, T_pair, st, scal, cot, **geo)
            before = ray_step.table_launches[interp]
            got = substep_vjp(ray_step.table_substep, T_pair, st, scal, cot, **geo)
            torch.cuda.synchronize()
            if ray_step.table_launches[interp] != before + 1:
                raise AssertionError(f"5a {interp} {dtype}: the forward did not launch the "
                                     f"table kernel once")
            errs = []
            for name, a, b in zip(("st", "scal"), got[1:], ref[1:]):
                scale = float(b.abs().max())
                torch.testing.assert_close(a, b, rtol=SUBSTEP_VJP_RTOL,
                                           atol=SUBSTEP_VJP_ATOL_OF_MAX * scale)
                errs.append(f"{name} {float((a - b).abs().max()) / scale:.3e}")
            gT, rT = got[0], ref[0]
            if gT.dtype != T_pair.dtype or not bool(torch.isfinite(gT).all()):
                raise AssertionError(f"5a {interp} {dtype}: the table's cotangent is not "
                                     f"finite {T_pair.dtype}")
            rows = [(g != 0).any(dim=1) for g in (gT, rT)]
            if not (torch.equal(*rows) and bool(rows[0].any())):
                raise AssertionError(f"5a {interp} {dtype}: the table's cotangent reaches "
                                     f"other rows than the twin's")
            t_scale = float(rT.float().abs().max())
            t_err = float((gT.float() - rT.float()).abs().max()) / t_scale
            if dtype == "float32":
                torch.testing.assert_close(gT, rT, rtol=0, atol=TABLE_VJP_ATOL_OF_MAX * t_scale)
            del ref, got, gT, rT
            fwd_ms = device_ms(lambda: ray_step.table_substep(T_pair, st, scal, **geo))
            torch.cuda.reset_peak_memory_stats()
            both_ms = device_ms(lambda: substep_vjp(ray_step.table_substep, T_pair, st, scal,
                                                    cot, **geo))
            peak = torch.cuda.max_memory_allocated() / 2**30
            times[interp, dtype] = both_ms
            held = (f"(limit {TABLE_VJP_ATOL_OF_MAX})" if dtype == "float32"
                    else "(not held: bf16 accumulation; finite, same rows)")
            print(f"5a TableSubstep backward {interp}, {dtype} table {tuple(T_pair.shape)}, "
                  f"N={n}: max |kernel VJP - twin autograd| / max: {', '.join(errs)} (rtol "
                  f"{SUBSTEP_VJP_RTOL}, atol {SUBSTEP_VJP_ATOL_OF_MAX} of max), T_pair "
                  f"{t_err:.3e} {held}, {int(rows[0].sum())} rows reached; forward + "
                  f"backward {both_ms:.4f} ms, forward alone {fwd_ms:.4f} ms, peak "
                  f"{peak:.2f} GiB [{card}]", flush=True)
            del T_pair
        del fo, fn, st, cot
        torch.cuda.empty_cache()
    return times


def frame_grad(device):
    """5b: d mean(k^2 + l^2) / d sol after one 128^2 x 16,384-packet frame
    of 5 steps (phase 3's set-up)."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    grid, model, sol0, rp, psih_fn = make_case(128, "bilinear", "float32", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    frame = make_coupled_frame(model, step, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0)
    packets = lattice_packets(128, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    sol = sol0.clone().requires_grad_()
    end = frame(SimState(sol, zero_clock(device=device), init(sol), packets,
                         fields_from_psih(psih_fn(sol), grid, rp.interp)))
    loss = torch.mean(end.packets.k ** 2 + end.packets.l ** 2)
    return torch.autograd.grad(loss, sol)[0]


def phase_gradient_gpu_vs_cpu(device) -> None:
    """5b: the RK4 frame's gradient on the card against the CPU's, and one
    midpoint frame (forward only) on both."""
    from juliaraytracingsw_tpu_torch.ops import ray_step

    before = ray_step.table_launches["bilinear"]
    first_cut = launch_counts()["first cut"]
    gpu = frame_grad(device)
    torch.cuda.synchronize()
    launched = ray_step.table_launches["bilinear"] - before
    if launched != 5 or launch_counts()["first cut"] != first_cut:
        raise AssertionError(f"5b: the GPU frame's gradient launched the table kernel "
                             f"{launched} times (not 5) or a first-cut kernel")
    cpu = frame_grad("cpu")
    rel = float(torch.linalg.vector_norm(gpu.cpu() - cpu) / torch.linalg.vector_norm(cpu))
    print(f"5b GPU vs CPU, d mean(k^2 + l^2) / d sol through one RK4 frame (128^2, 16384 "
          f"packets, 5 steps, f32 tables): relative L2 {rel:.3e} (limit {GRAD_L2_RTOL}), "
          f"|grad| {float(torch.linalg.vector_norm(cpu)):.4e}; table kernel launches "
          f"{launched}", flush=True)
    if not rel <= GRAD_L2_RTOL:
        raise AssertionError("5b: the GPU and CPU gradients disagree")
    phase_gpu_vs_cpu(device, "midpoint")


def events_ms(fn, warmup: int = 1, trials: int = 3) -> list[float]:
    """Wall milliseconds of ``fn()`` between CUDA events, each trial ended
    by a synchronize, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def peak_gib(fn):
    """One call of ``fn`` -> (its result, the peak of
    ``torch.cuda.max_memory_allocated`` during it, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def phase_hero_fwd_bwd(card: str, device, nx: int = 512, sqrtp: int = 1024) -> dict:
    """5c: the hero's differentiable step (``bench.py:324-341``): 512^2 RSW,
    IF-AB3, 1,048,576 packets, bilinear, bf16 tables, one RK4 substep;
    value and gradient of mean(k^2 + l^2) with respect to sol."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih, raytrace

    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "bfloat16", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    packets = lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)

    def value_and_grad():
        sol = sol0.clone().requires_grad_()
        fields_old = fields_from_psih(psih_fn(sol), grid, rp.interp)
        sol1, _, _ = step(sol, zero_clock(device=device), init(sol))
        fields_new = fields_from_psih(psih_fn(sol1), grid, rp.interp)
        out = raytrace(packets, fields_old, fields_new, 0.0, DT, rp, nsubsteps=1)
        loss = torch.mean(out.k ** 2 + out.l ** 2)
        (grad,) = torch.autograd.grad(loss, sol)
        return loss.detach(), grad

    ray_step.reset_launches()
    loss, grad = value_and_grad()
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["table"]["bilinear"] != 1 or counts["first cut"] or any(
            counts["table attempt"].values()):
        raise AssertionError(f"5c: the hero's fwd+bwd step launched {counts}, not the table "
                             f"kernel once")
    gnorm = float(torch.linalg.vector_norm(grad))
    if not (bool(torch.isfinite(grad.abs()).all()) and gnorm > 0):
        raise AssertionError(f"5c: the hero's gradient is not finite and nonzero ({gnorm})")
    del grad
    ms = events_ms(value_and_grad)
    _, peak = peak_gib(value_and_grad)
    print(f"5c hero fwd+bwd step ({nx}^2 RSW + {packets.n} packets, bilinear, bf16 tables, one "
          f"RK4 substep): loss {float(loss):.6e}, |grad| {gnorm:.4e}, table kernel launches "
          f"{counts['table']['bilinear']}, first-cut launches {counts['first cut']}; "
          f"{min(ms):.3f} ms (min of {len(ms)}, spread {max(ms) - min(ms):.3f} ms: "
          f"{', '.join(f'{m:.3f}' for m in ms)}), peak {peak:.3f} GiB [{card}]", flush=True)
    return dict(ms=min(ms), spread=max(ms) - min(ms), peak_gib=peak)


def phase_long_gradient(card: str, device, nx: int = 512, steps: int = 100,
                        short: int = 10) -> dict:
    """5d: ``bench.py:343-376``: the gradient of mean(k^2 + l^2) with respect
    to sol through 100 coupled 512^2 steps, taps gather, 16,384 packets,
    remat; then the 10-step gradient with and without remat, held equal."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "float32", device)
    rp = rp._replace(gather="taps")
    init, step = build_stepper(model, "IFMAB3", DT)
    packets = lattice_packets(128, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)

    def grad_through(steps: int, remat: bool):
        frame = make_coupled_frame(model, step, psih_fn, rp, flow_steps=steps,
                                   ray_substeps=1, k_cutoff=K_CUTOFF, k0=K0, remat=remat)

        def run():
            sol = sol0.clone().requires_grad_()
            fields = fields_from_psih(psih_fn(sol), grid, rp.interp)
            out = frame(SimState(sol, zero_clock(device=device), init(sol), packets, fields))
            loss = torch.mean(out.packets.k ** 2 + out.packets.l ** 2)
            return torch.autograd.grad(loss, sol)[0]
        return run

    run100 = grad_through(steps, True)
    g100 = run100()
    if not bool(torch.isfinite(g100.abs()).all()):
        raise AssertionError(f"5d: the {steps}-step gradient is not finite")
    gnorm = float(torch.linalg.vector_norm(g100))
    del g100
    ms = events_ms(run100, warmup=0, trials=2)
    _, peak100 = peak_gib(run100)
    grads, peaks = {}, {}
    for remat in (False, True):
        grads[remat], peaks[remat] = peak_gib(grad_through(short, remat))
    rel = float((grads[True] - grads[False]).abs().max() / grads[False].abs().max())
    print(f"5d gradient through {steps} coupled {nx}^2 steps (remat, taps gather, "
          f"{packets.n} packets): |grad| {gnorm:.4e}, {min(ms) / 1e3:.4f} s (min of {len(ms)}: "
          f"{', '.join(f'{m / 1e3:.4f}' for m in ms)} s), peak {peak100:.3f} GiB; {short} steps: "
          f"peak {peaks[True]:.3f} GiB with remat, {peaks[False]:.3f} GiB without, max "
          f"|remat - plain| / max {rel:.3e} (limit {REMAT_RTOL}) [{card}]", flush=True)
    if not rel <= REMAT_RTOL:
        raise AssertionError("5d: the remat gradient differs from the plain one")
    return dict(s=min(ms) / 1e3, peak_gib=peak100, peak10_remat=peaks[True],
                peak10_plain=peaks[False])


def hero_argv(out_dir: str, platform: str = "cuda", nx: int = 512,
              sqrtp: int = 1024) -> list[str]:
    """The RK4 hero as a command line: 512^2 RSW, 1,048,576 packets,
    bilinear bf16 tables, 'auto' gather; phase 4's IC (seed 1, ag 0.5, aw
    0.05), dt (the CFL tune that gives DT) and schedule: 200 spinup steps,
    then 4 frames of 5 flow steps."""
    dx = 2 * np.pi / nx
    spinup_T, output_dt = 200.5 * DT, 5.5 * DT
    return ["rsw", "--nx", str(nx), "--sqrt-npackets", str(sqrtp), "--interp", "bilinear",
            "--table-dtype", "bfloat16", "--ray-method", "rk4", "--gather", "auto",
            "--seed", "1", "--ag", "0.5", "--aw", "0.05", "--cfltune", repr(DT * 2.0 / dx),
            "--spinup-T", repr(spinup_T), "--output-dt", repr(output_dt),
            "--T", repr(spinup_T + 4.5 * output_dt), "--out-dir", out_dir,
            "--checkpoint", os.path.join(out_dir, "hero.npz"), "--platform", platform]


class DiscardingWriter:
    """Takes what the driver hands a packet writer, already copied to the
    host, and keeps nothing: the telemetry's cost without an HDF5 write."""

    def write(self, key, value):
        pass

    def write_packets(self, step, t, x=None, k=None, u=None, g=None):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def drive_cli(argv: list[str], log_fn, packet_writer=None, marks: list | None = None):
    """A coupled subcommand's run without its HDF5 outputs: the case and
    the driver built by ``experiments.__main__`` itself, then init, spinup,
    (``single-wave``: the injected wave), frames and the checkpoint, as the
    command line runs them. ``marks`` gets a CUDA event recorded just
    before the frames."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    args = cli.build_parser().parse_args(argv)
    case = cli.SETUPS[args.cmd](args)
    drv = cli.make_driver(args, case, packet_writer=packet_writer, log_fn=log_fn)
    drv.init(case.sol0, case.packets, clock=cli.start_clock(case, case.sol0.device))
    spinup_steps, frames, steps_per_frame = cli.schedule(args)
    drv.spinup(spinup_steps)
    if args.cmd == "single-wave":
        drv.sim = drv.sim._replace(sol=cli.inject(args, case, drv.sim.sol))
    if marks is not None:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    drv.run(frames, steps_per_frame)
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    return drv, case, (spinup_steps, frames, steps_per_frame)


def timed_cli(argv: list[str], tag: str, writers: str):
    """One run of the command line (``writers='hdf5'``: ``main``, all its
    files; 'telemetry': ``drive_cli`` with the packet telemetry dropped on
    the host; 'none': ``drive_cli`` with no writers) -> (driver, its case,
    frame ms between the ends of consecutive frames, CUDA events)."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    marks = []

    def log_fn(line):
        if line.startswith("step:"):       # a frame's end, after its outputs
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        print(f"  [{tag}] {line}")

    if writers == "hdf5":
        drv = cli.run(argv, log_fn=log_fn)
        args = cli.build_parser().parse_args(argv)
        case = cli.setup_rsw(args)
    else:
        sink = DiscardingWriter() if writers == "telemetry" else None
        drv, case, _ = drive_cli(argv, log_fn, packet_writer=sink)
    torch.cuda.synchronize()
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    return drv, case, frame_ms


def phase_cli_hero(card: str, device, out_dir: str, phase4_steps_per_s: float) -> dict:
    """6a: the RK4 hero through the command line; the main path of phase 6."""
    from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.ops import ray_step

    argv = hero_argv(out_dir)
    have_h5py = importlib.util.find_spec("h5py") is not None
    if not have_h5py:
        print("6a: h5py is not installed on this machine, so the command line cannot write "
              "its rolling HDF5 outputs or diagnostics.h5 (io/output imports h5py, as the "
              "reference does): the same path runs through CoupledDriver built by the "
              "command line's own setup (experiments.__main__.setup_rsw, make_driver), "
              "without writers, diagnostics kept in memory; the checkpoint (numpy) is "
              "written")
    ray_step.reset_launches()
    with kernel_runs() as runs:
        drv, case, frame_ms = timed_cli(argv, "cli hero", "hdf5" if have_h5py else "none")
    counts = launch_counts()
    res = dict(launches=runs["table"], table_counts={**counts["table"], "bilinear": runs["table"]},
               first_cut=runs["first cut"], gather=drv.rp.gather,
               writers="hdf5" if have_h5py else "none")
    if res["gather"] != "patch":
        raise AssertionError(f"6a: --gather auto resolved to {res['gather']}, not patch")
    others = {k: v for k, v in counts["table"].items() if k != "bilinear"}
    if res["launches"] != 20 or res["first_cut"] or any(others.values()) or runs[
            "table attempt"] or any(counts["table attempt"].values()):
        raise AssertionError(f"6a: the command line's hero launched {counts}, not the "
                             f"bilinear table kernel 20 times")
    grid, params = case.model.grid, case.model.params
    e0 = float(rsw.total_energy(case.sol0, grid, params))
    sim = drv.sim
    e1 = float(rsw.total_energy(sim.sol, grid, params))
    kmax = float(torch.sqrt(sim.packets.k ** 2 + sim.packets.l ** 2).max())
    finite = all(bool(torch.isfinite(t.abs()).all()) for _, t in _flatten(sim)
                 if isinstance(t, torch.Tensor))
    if have_h5py:
        import h5py

        from juliaraytracingsw_tpu_torch.io.output import SequencedReader

        n_packet = len(SequencedReader(os.path.join(out_dir, "packets")).packet_times())
        n_snap = SequencedReader(os.path.join(out_dir, "rsw")).count()
        with h5py.File(os.path.join(out_dir, "diagnostics.h5"), "r") as f:
            diags = {k: f[k][()] for k in f}
    else:
        n_packet = n_snap = None
        diags = {"t": np.asarray(drv.diag_times),
                 **{k: np.asarray(v) for k, v in drv.diag_series.items()}}
    diag_ok = all(len(v) == 4 and np.isfinite(v).all() for v in diags.values())
    res.update(dE=abs(e1 - e0) / e0, kmax=kmax, finite=finite, frame_ms=frame_ms,
               steps_per_s=5 * len(frame_ms) / (sum(frame_ms) / 1e3))
    files = (f"{n_packet} packet frames and {n_snap} snapshots in HDF5" if have_h5py
             else "no HDF5 files (no h5py)")
    print(f"6a hero through the command line (rsw, {grid.nx}^2, {sim.packets.n} packets, bilinear, "
          f"bf16 tables, --gather auto -> {res['gather']}): table kernel runs "
          f"{res['launches']}, first-cut runs {res['first_cut']}; {files}; diagnostics "
          f"{sorted(diags)} finite {diag_ok}; energy change {res['dE']:.3e}; max |k| "
          f"{kmax:.3f} (cutoff {K_CUTOFF}); finite {finite}; checkpoint "
          f"{os.path.getsize(os.path.join(out_dir, 'hero.npz')) / 2**20:.1f} MiB [{card}]")
    if not (finite and diag_ok and res["dE"] < 0.01 and kmax < K_CUTOFF
            and (not have_h5py or (n_packet == 4 and n_snap == 4))):
        raise AssertionError("6a: the command line's hero failed its checks")
    # the same run again without writers (and, without h5py, with the
    # telemetry copied to the host and dropped): coupled steps/s of each
    rates = {res["writers"]: res["steps_per_s"]}
    for writers in (("none",) if have_h5py else ("telemetry",)):
        with tempfile.TemporaryDirectory() as tmp:
            other = timed_cli(hero_argv(tmp), f"cli hero, writers {writers}", writers)[2]
        rates[writers] = 5 * len(other) / (sum(other) / 1e3)
    res["rates"] = rates
    label = {"hdf5": "with the HDF5 writers", "none": "without writers",
             "telemetry": "with the packet telemetry copied to the host and dropped (no HDF5)"}
    print("6a coupled steps/s over the last 3 frames, frame ends by CUDA events: "
          + "; ".join(f"{label[k]} {v:.2f}" for k, v in rates.items())
          + f"; phase 4 (CoupledDriver, no writers) {phase4_steps_per_s:.2f} [{card}]",
          flush=True)
    res["sim"] = sim
    return res


def phase_resume(card: str, device) -> None:
    """6b: checkpoint after frame 2 of the hero (the command line's case),
    2 more frames; a fresh driver restored from the checkpoint runs the
    same 2 frames to the same bits."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten

    with tempfile.TemporaryDirectory() as tmp:
        args = cli.build_parser().parse_args(hero_argv(tmp))
        case = cli.setup_rsw(args)
        path = os.path.join(tmp, "frame2.npz")
        a = cli.make_driver(args, case, log_fn=lambda line: None)
        a.init(case.sol0, case.packets)
        a.run(2, 5)
        a.checkpoint(path)
        a.run(2, 5)
        b = cli.make_driver(args, case, log_fn=lambda line: None)
        b.init(case.sol0, case.packets)
        b.restore(path)
        b.run(2, 5)
    torch.cuda.synchronize()
    diff = [p for (p, x), (_, y) in zip(_flatten(a.sim), _flatten(b.sim))
            if not (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)]
    print(f"6b resume on the card ({case.model.grid.nx}^2, {a.sim.packets.n} packets): after "
          f"restoring frame "
          f"2's checkpoint and 2 more frames, leaves not bit-equal: {diff or 'none'} "
          f"(step {b.sim.clock.step}) [{card}]", flush=True)
    if diff:
        raise AssertionError(f"6b: the resumed run differs in {diff}")


def phase_restore_on_cpu(card: str, out_dir: str, gpu_sim) -> None:
    """6c: 6a's checkpoint restored into the command line's driver on the
    CPU; every leaf equals the card's state."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten

    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(hero_argv(out_dir, platform="cpu"))
    case = cli.setup_rsw(args)
    drv = cli.make_driver(args, case, log_fn=lambda line: None)
    drv.init(case.sol0, case.packets)
    drv.restore(os.path.join(out_dir, "hero.npz"))
    diff = []
    for (p, x), (_, y) in zip(_flatten(drv.sim), _flatten(gpu_sim), strict=True):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu" or not torch.equal(x, y.cpu()):
                diff.append(p)
        elif x != y:
            diff.append(p)
    print(f"6c the card's checkpoint restored on the CPU: {len(_flatten(gpu_sim))} leaves, "
          f"not equal: {diff or 'none'} ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    if diff:
        raise AssertionError(f"6c: the CPU restore differs in {diff}")


def small_cli_argv(out_dir: str, platform: str) -> list[str]:
    return ["rsw", "--nx", "128", "--sqrt-npackets", "128", "--gather", "patch", "--seed", "42",
            "--ag", "0.5", "--aw", "0.05", "--spinup-T", "0.05", "--T", "0.3",
            "--output-dt", "0.05", "--out-dir", out_dir, "--platform", platform]


def cli_outputs(argv: list[str], have_h5py: bool):
    """(diagnostics {name: series}, last packets {x, k}) of one command line
    run: from its files, or without h5py from its driver."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    quiet = lambda line: None   # noqa: E731
    if have_h5py:
        import h5py

        from juliaraytracingsw_tpu_torch.io.output import SequencedReader

        cli.run(argv, log_fn=quiet)
        out_dir = argv[argv.index("--out-dir") + 1]
        with h5py.File(os.path.join(out_dir, "diagnostics.h5"), "r") as f:
            diags = {k: f[k][()] for k in f}
        _, frame = SequencedReader(os.path.join(out_dir, "packets")).final_packet_frame()
        return diags, {"x": frame["x"], "k": frame["k"]}
    drv = drive_cli(argv, quiet)[0]
    p = drv.sim.packets
    diags = {"t": np.asarray(drv.diag_times),
             **{k: np.asarray(v) for k, v in drv.diag_series.items()}}
    return diags, {"x": torch.stack([p.x, p.y], 1).cpu().numpy(),
                   "k": torch.stack([p.k, p.l], 1).cpu().numpy()}


def phase_cli_gpu_vs_cpu(card: str) -> None:
    """6d: one small run through the command line on the card and on the
    CPU: diagnostics within rtol CLI_DIAG_RTOL, the last packet frame within
    FRAME_PACKET_ATOL."""
    have_h5py = importlib.util.find_spec("h5py") is not None
    with tempfile.TemporaryDirectory() as tmp:
        gd, gp = cli_outputs(small_cli_argv(os.path.join(tmp, "gpu"), "cuda"), have_h5py)
        cd, cp = cli_outputs(small_cli_argv(os.path.join(tmp, "cpu"), "cpu"), have_h5py)
    diag_err = max(float(np.max(np.abs(gd[k] - cd[k]) / np.abs(cd[k]))) for k in cd)
    pk_err = max(float(np.abs(gp[k] - cp[k]).max()) for k in cp)
    how = "the command line's files" if have_h5py else "the driver (no h5py: no files)"
    print(f"6d the command line GPU vs CPU (rsw 128^2, 16384 packets, patch, 20 spinup + 5 x 20 "
          f"steps; read from {how}): diagnostics {sorted(cd)} max rel err {diag_err:.3e} "
          f"(limit {CLI_DIAG_RTOL}), last packets max abs err {pk_err:.3e} (limit "
          f"{FRAME_PACKET_ATOL}) [{card}]", flush=True)
    if not (diag_err <= CLI_DIAG_RTOL and pk_err <= FRAME_PACKET_ATOL
            and all(len(v) == 5 for v in cd.values())):
        raise AssertionError("6d: the command line's GPU and CPU runs disagree")


# phase 7: the other flow models. 7a: bench.py:282-310's 2048^2 two-layer
# flow; the rest through the command line's set-up without writers (the
# card's machine has no h5py), bilinear bf16 tables, the hero's dt
TWOLAYER_FLOW_NX, TWOLAYER_FLOW_STEPS = 2048, 40
TY_NX, TY_STEPS, TY_NSUBS = 512, 40, 10
VARIANTS = ("linborg", "modified", "quadheight")
# the hero's IC for the RSW variants (seed 1, ag 0.5, aw 0.05)
HERO_IC = ("--seed", "1", "--ag", "0.5", "--aw", "0.05")


class host_seconds:
    """Within the block, every call of ``module.name`` appends its host
    wall seconds to ``self.seconds``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def coupled_argv(cmd: str, nx: int, sqrtp: int, frames: int, *extra: str,
                 platform: str = "cuda", spinup_steps: int = 0,
                 gather: str = "auto") -> list[str]:
    """A coupled subcommand at nx^2 with sqrtp^2 packets, bilinear bf16
    tables, RK4, the hero's dt (its CFL tune), ``spinup_steps`` flow steps,
    then ``frames`` frames of 5 steps, no outputs."""
    dx = 2 * np.pi / nx
    spinup_T, output_dt = (spinup_steps + 0.5) * DT, 5.5 * DT
    return [cmd, "--nx", str(nx), "--sqrt-npackets", str(sqrtp), "--interp", "bilinear",
            "--table-dtype", "bfloat16", "--ray-method", "rk4", "--gather", gather,
            "--cfltune", repr(DT * 2.0 / dx), "--spinup-T", repr(spinup_T),
            "--output-dt", repr(output_dt), "--T", repr(spinup_T + (frames + 0.5) * output_dt),
            "--platform", platform, *extra]


def sim_finite(sim) -> bool:
    from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten

    return all(bool(torch.isfinite(t.abs()).all()) for _, t in _flatten(sim)
               if isinstance(t, torch.Tensor))


def phase_cli_case(card: str, argv: list[str], tag: str, gather: str, launches: int) -> dict:
    """One coupled subcommand through ``drive_cli`` with its launches
    counted from 0: 'auto' must resolve to ``gather``, the bilinear table
    kernel launch ``launches`` times and no other ray kernel; the state
    finite, |k| < k_cutoff. Coupled steps/s over the frames after the first
    (or over the one frame, first call included), frame ends by CUDA
    events."""
    from juliaraytracingsw_tpu_torch.ops import ray_step

    marks = []

    def log_fn(line):
        if line.startswith("step:"):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    ray_step.reset_launches()
    with kernel_runs() as runs:
        drv, case, (_, frames, steps_per_frame) = drive_cli(argv, log_fn, marks=marks)
    counts = launch_counts()
    # the diagnostics each frame records before its end mark, timed alone
    t0 = time.perf_counter()
    for fn in case.diagnostics.values():
        fn(drv.sim.sol, case.model.grid, case.model.params).cpu()
    diag_ms = (time.perf_counter() - t0) * 1e3
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    steady = frame_ms[1:] or frame_ms
    rate = steps_per_frame * len(steady) / (sum(steady) / 1e3)
    sim = drv.sim
    kmax = float(torch.sqrt(sim.packets.k ** 2 + sim.packets.l ** 2).max())
    finite = sim_finite(sim)
    diags = {k: np.asarray(v) for k, v in drv.diag_series.items()}
    diag_ok = all(len(v) == frames and np.isfinite(v).all() for v in diags.values())
    grid = case.model.grid
    over = (f"over the last {len(steady)} frames" if len(steady) < len(frame_ms)
            else "over 1 frame, first call included")
    print(f"{tag} ({argv[0]}, {grid.nx}^2, {sim.packets.n} packets, {frames} x {steps_per_frame} steps, "
          f"--gather auto -> {drv.rp.gather}): {rate:.2f} coupled steps/s {over} (frame ms "
          f"{', '.join(f'{m:.2f}' for m in frame_ms)}); table kernel runs "
          f"{runs['table']}, first-cut runs {runs['first cut']}; "
          f"diagnostics {sorted(diags)} finite {diag_ok}, {diag_ms:.2f} ms a frame (host "
          f"clock); max |k| {kmax:.3f} (cutoff "
          f"{K_CUTOFF}); finite {finite}; no writers [{card}]", flush=True)
    others = {k: v for k, v in counts["table"].items() if k != "bilinear"}
    if drv.rp.gather != gather:
        raise AssertionError(f"{tag}: --gather auto resolved to {drv.rp.gather}, not {gather}")
    if (runs["table"] != launches or runs["first cut"] or runs["table attempt"]
            or any(others.values()) or any(counts["table attempt"].values())):
        raise AssertionError(f"{tag}: ran {runs}, launched {counts}, not the bilinear table "
                             f"kernel {launches} times")
    if not (finite and diag_ok and kmax < K_CUTOFF):
        raise AssertionError(f"{tag}: the run failed its checks")
    return dict(launches=runs["table"], steps_per_s=rate, frame_ms=frame_ms,
                diag_ms=diag_ms)


def phase_twolayer_flow(card: str, device, nx: int = TWOLAYER_FLOW_NX,
                        steps: int = TWOLAYER_FLOW_STEPS) -> dict:
    """7a: ``bench.py:282-310``'s flow row: nx^2 two-layer QG, U 0.2, mu
    1e-2, nnu 4, nu from the hero's dt, IF-AB3 over (2, 2) block tables,
    the seed-7 IC; ``steps`` steps timed by CUDA events after one warm-up
    call of as many; the host seconds of the two expm tables."""
    from juliaraytracingsw_tpu_torch.core import steppers
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.spectral import rfft2
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import derive_nu
    from juliaraytracingsw_tpu_torch.models import twolayerqg
    from juliaraytracingsw_tpu_torch.models.base import build_stepper, run

    grid = make_grid(nx, device=device)
    model = twolayerqg.make_model(grid, U=0.2, mu=1e-2, nu=derive_nu(1.0, nx, 4, DT), nnu=4)
    with host_seconds(steppers, "expm_tables") as expm:
        init, step = build_stepper(model, "IFMAB3", DT)
    phys = np.random.default_rng(7).standard_normal((2, nx, nx)).astype(np.float32)
    sol0 = rfft2(torch.as_tensor(phys, device=device)) * grid.dealias_mask
    sol0 = (0.3 * sol0 * torch.exp(-grid.Krsq / 20.0**2) / sol0.abs().max()).to(torch.complex64)

    def energy(sol):
        ke1, ke2 = twolayerqg.kinetic_energy(sol, grid, model.params)
        return float(ke1 + ke2 + twolayerqg.potential_energy(sol, grid, model.params))

    def go():
        return run(step, sol0, zero_clock(device=device), init(sol0), steps)[0]

    ms = events_ms(go, warmup=1, trials=1)[0]
    sol = go()
    e0, e1 = energy(sol0), energy(sol)
    finite = bool(torch.isfinite(torch.view_as_real(sol)).all())
    rate = steps / (ms / 1e3)
    print(f"7a twolayer2048_flow ({nx}^2 two-layer QG, IF-AB3 (2, 2) blocks, {steps} steps): "
          f"{rate:.2f} flow steps/s ({ms:.1f} ms, CUDA events, after a warm-up call); "
          f"expm_tables host seconds {', '.join(f'{t:.2f}' for t in expm.seconds)} (exp(L dt) "
          f"and exp(2 L dt): two batched 2x2 scipy.linalg.expm over {grid.nl * grid.nkr} "
          f"modes); energy "
          f"{e0:.6e} -> {e1:.6e}, change {abs(e1 - e0) / e0:.3e}; finite {finite} [{card}]",
          flush=True)
    if not (finite and np.isfinite(e1)):
        raise AssertionError("7a: the 2048^2 two-layer flow is not finite")
    return dict(steps_per_s=rate, expm_s=expm.seconds, dE=abs(e1 - e0) / e0)


def phase_thomasyamada(card: str, device, nx: int = TY_NX, steps: int = TY_STEPS,
                       nsubs: int = TY_NSUBS) -> dict:
    """7e: Thomas-Yamada at nx^2, ETDRK4, the command line's configuration
    (``setup_thomasyamada``): a startup phase and a main phase of ``steps``
    steps each through ``ty_driver._phase`` without a writer, chunks of
    ``nsubs``; steps/s over each phase's chunks after the first (CUDA
    events at the chunks' log lines), the host seconds of
    ``_etdrk4_coeffs``, the last energies."""
    from juliaraytracingsw_tpu_torch.core import steppers
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled import ty_driver
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import ty_initial_condition
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.models import thomasyamada

    marks = {"startup": [], "main": []}

    def log_fn(line):
        label = line[1:line.index("]")]
        marks[label].append(torch.cuda.Event(enable_timing=True))
        marks[label][-1].record()
        print(f"  [7e] {line}")

    args = cli.build_parser().parse_args(["thomasyamada", "--nx", str(nx), "--platform",
                                          torch.device(device).type])
    cfg = cli.setup_thomasyamada(args, log_fn)
    grid = make_grid(nx, Lx=cfg.Lx, device=device)
    model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    sol = ty_initial_condition(grid, np.random.default_rng(cfg.seed), cfg.k0g_range,
                               cfg.k0w_range, cfg.at, cfg.ag, cfg.aw)
    clock = zero_clock(device=device)
    diags = {k: [] for k in ty_driver.DIAG_KEYS}
    start = time.time()
    with host_seconds(steppers, "_etdrk4_coeffs") as coeffs:
        for label, dt in (("startup", cfg.startup_dt), ("main", cfg.dt)):
            sol, clock = ty_driver._phase(model, cfg, sol, clock, dt, steps, nsubs, None,
                                          diags, label, start)
    torch.cuda.synchronize()
    rates = {}
    for label, ev in marks.items():
        ms = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
        rates[label] = nsubs * len(ms) / (sum(ms) / 1e3)
    last = {k: v[-1] for k, v in diags.items()}
    finite = all(np.isfinite(v).all() for v in diags.values()) and bool(
        torch.isfinite(torch.view_as_real(sol)).all())
    print(f"7e Thomas-Yamada ({nx}^2, {cfg.stepper}, startup dt {cfg.startup_dt:g} and main "
          f"dt {cfg.dt:g}, {steps} steps each in chunks of {nsubs}, no writer): steps/s over "
          f"the last {steps // nsubs - 1} chunks (diagnostics included) startup "
          f"{rates['startup']:.2f}, main {rates['main']:.2f}; _etdrk4_coeffs host seconds "
          f"{', '.join(f'{t:.2f}' for t in coeffs.seconds)}; at t={last['t']:.3f} wave KE "
          f"{last['wave_ke']:.6e}, PE {last['wave_pe']:.6e}, geo KE {last['geo_ke']:.6e}, PE "
          f"{last['geo_pe']:.6e}, barotropic {last['barotropic']:.6e}; finite {finite} "
          f"[{card}]", flush=True)
    if not finite or len(coeffs.seconds) != 2:
        raise AssertionError("7e: the Thomas-Yamada run failed its checks")
    return dict(steps_per_s=rates, coeffs_s=coeffs.seconds)


def rel_err(gpu: torch.Tensor, cpu: torch.Tensor) -> float:
    """max |gpu - cpu| over max |cpu|."""
    return float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())


def phase_models_gpu_vs_cpu(card: str) -> None:
    """7g: each new path on the card against the CPU, held as phase 3
    holds one frame (sol FRAME_SOL_RTOL of its largest mode, packets
    FRAME_PACKET_ATOL): a 128^2 two-layer coupled frame, a 64^2 3-layer
    frame and a 64^2 single-wave frame through the command line's set-up;
    TY ETDRK4 at 64^2 after 10 and 20 steps; 10 steps of IFRK4,
    FilteredAB3 and FilteredRK4 on the hero's RSW at 64^2."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import ty_initial_condition
    from juliaraytracingsw_tpu_torch.models import thomasyamada
    from juliaraytracingsw_tpu_torch.models.base import build_stepper, run

    quiet = lambda line: None   # noqa: E731
    rows = []
    frames = {
        "two-layer coupled frame, 128^2, 16384 packets": ("twolayer", 128, 128, ()),
        "3-layer coupled frame, 64^2, 4096 packets": ("twolayer", 64, 64, ("--nlayers", "3")),
        "single-wave frame, 64^2, 2 packets, 5 spinup steps": ("single-wave", 64, 1, ()),
    }
    for what, (cmd, nx, sqrtp, extra) in frames.items():
        spinup = 5 if cmd == "single-wave" else 0
        sims = [drive_cli(coupled_argv(cmd, nx, sqrtp, 1, *extra, platform=platform,
                                       spinup_steps=spinup), quiet)[0].sim
                for platform in ("cuda", "cpu")]
        pk = max(float((getattr(sims[0].packets, n).cpu() - getattr(sims[1].packets, n))
                       .abs().max()) for n in ("x", "y", "k", "l"))
        rows.append((what, rel_err(sims[0].sol, sims[1].sol), pk))

    def stepped(make, stepper, nsteps_list):
        """sol after each count of ``nsteps_list`` (cumulative) on both
        devices -> [(steps, rel err)]."""
        out = {}
        for device in ("cuda", "cpu"):
            model, sol = make(device)
            init, step = build_stepper(model, stepper, DT)
            clock, state, done = zero_clock(device=device), init(sol), 0
            for n in nsteps_list:
                sol, clock, state = run(step, sol, clock, state, n - done)
                done = n
                out.setdefault(n, []).append(sol)
        return [(n, rel_err(*sols)) for n, sols in out.items()]

    def rsw64(device):
        _, model, sol0, _, _ = make_case(64, "bilinear", "float32", device)
        return model, sol0

    def ty64(device):
        grid = make_grid(64, device=device)
        model = thomasyamada.make_model(grid)
        sol = ty_initial_condition(grid, np.random.default_rng(5678), (2, 6), (0, 4), 0.1,
                                   0.1, 0.05)
        return model, sol

    for stepper in ("IFRK4", "FilteredAB3", "FilteredRK4"):
        for n, err in stepped(rsw64, stepper, [10]):
            rows.append((f"{stepper} on RSW 64^2, {n} steps", err, None))
    for n, err in stepped(ty64, "ETDRK4", [10, 20]):
        rows.append((f"ETDRK4 on TY 64^2, {n} steps", err, None))
    for what, sol_err, pk_err in rows:
        pk = "" if pk_err is None else (f", packet max abs err {pk_err:.3e} (limit "
                                        f"{FRAME_PACKET_ATOL})")
        print(f"7g GPU vs CPU, {what}: sol rel err {sol_err:.3e} (limit {FRAME_SOL_RTOL})"
              f"{pk} [{card}]", flush=True)
    bad = [what for what, sol_err, pk_err in rows
           if not (sol_err < FRAME_SOL_RTOL and (pk_err is None or pk_err < FRAME_PACKET_ATOL))]
    if bad:
        raise AssertionError(f"7g: GPU and CPU disagree in {bad}")


def phase_models(card: str, device) -> dict:
    """Phase 7; returns the bilinear table kernel's launches per path."""
    t0 = time.perf_counter()
    print("phase 7 runs every command line case without writers: the card's machine has "
          "no h5py; twolayer --ic-file, twolayer-simulation and the TY restart are held "
          "by the CPU tests", flush=True)
    phase_twolayer_flow(card, device)
    launches = {}
    # 7b: the reference's production two-layer raytracing size; taps
    phase_cli_case(card, coupled_argv("twolayer", 2048, 512, 4), "7b", "taps", 0)
    # 7c: the ray kernel on the two-layer flow, barotropic and baroclinic
    for extra in ((), ("--baroclinic",)):
        tag = "7c" + (" baroclinic" if extra else "")
        launches[tag] = phase_cli_case(card, coupled_argv("twolayer", 512, 1024, 4, *extra),
                                       tag, "patch", 20)["launches"]
    launches["7d"] = phase_cli_case(card, coupled_argv("twolayer", 512, 512, 1, "--nlayers",
                                                       "3"), "7d 3 layers", "patch",
                                    5)["launches"]
    phase_thomasyamada(card, device)
    for model in VARIANTS:
        launches[f"7f {model}"] = phase_cli_case(
            card, coupled_argv("rsw", 512, 1024, 1, "--model", model, *HERO_IC),
            f"7f {model}", "patch", 5)["launches"]
    phase_models_gpu_vs_cpu(card)
    print(f"phase 7 done in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 8: Weibull birth/death (the hero_bd row, bench.py:202), steady
# raytracing through the command line, and the other new paths GPU vs CPU
BD_SOURCE = "juliaraytracingsw_tpu_torch/csrc/birth_death.cu"
BD_REPLACES = "juliaraytracingsw_tpu/rays/resample.py:66"
BD_CONSTS = dict(k_shape=1.5, lam=10.0)
HERO_BD = dict(birth_death=True, bd_k_shape=1.5, bd_lam=10.0, bd_seed=0)
# float32 words a packet reads (a live one x y k l sign age lifetime, a dead
# one its age and lifetime only: the rest are drawn) and writes (all seven,
# then a byte of dead mask)
BD_LIVE_READS, BD_DEAD_READS, BD_WRITES = 7, 2, 7
BD_OUTPUTS = ("x", "y", "k", "l", "sign", "age", "lifetime", "key", "births", "dead")
# 8a: each call a dt of 4 mean-10 lifetimes' worth: a third of the ensemble dies
BD_DT = 4.0


def max_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in units of b's float spacing."""
    a, b = a.cpu().double().numpy(), b.cpu().numpy()
    return float((np.abs(a - b) / np.spacing(np.abs(b).astype(b.dtype))).max()) if b.size else 0.0


def bd_inputs(n: int, device) -> list:
    """The birth/death kernel's inputs at n = sqrtp^2 packets: the hero's
    lattice and ``init_birth_death(prng_key(0), n)``."""
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.prng import prng_key
    from juliaraytracingsw_tpu_torch.rays.resample import init_birth_death

    sqrtp = int(round(np.sqrt(n)))
    L = 2 * np.pi
    packets = lattice_packets(sqrtp, L, L, k0=K0, k_ring=True, device=device)
    return [*packets, *init_birth_death(prng_key(0, device=device), n, **BD_CONSTS)]


def check_bd_outputs(what: str, out, ref, *, lifetime_ulps: float = 1.0) -> float:
    """Every output bit-equal but lifetimes (within ``lifetime_ulps``) ->
    their largest float difference."""
    err = 0.0
    for name, a, b in zip(BD_OUTPUTS, out, ref):
        b = b.to(a.device)
        if name == "lifetime":
            ulps = max_ulps(a, b)
            if ulps > lifetime_ulps:
                raise AssertionError(f"{what}: lifetimes {ulps} ulps apart")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()))
    return err


def phase_birth_death_kernel(card: str, device, sizes=(1 << 18, 1 << 20)) -> dict:
    """8a: the birth/death kernel against its twin at 262,144 and 1,048,576
    packets over 3 chained calls (each fed the kernel's last output, so the
    two meet the same inputs), the twin on the card against the twin on the
    CPU; then each timed in a CUDA graph at the last call's inputs ->
    {n: row}."""
    from juliaraytracingsw_tpu_torch.ops import birth_death as bd
    from juliaraytracingsw_tpu_torch.profiling._timing import bound_ms, device_ms, time_ms

    L = 2 * np.pi
    consts = dict(Lx=L, Ly=L, k0=K0, x0=-L / 2, y0=-L / 2, **BD_CONSTS)
    rows = {}
    for n in sizes:
        t0 = time.perf_counter()
        state = bd_inputs(n, device)
        dt = torch.tensor(BD_DT, device=device)
        err, deaths, same_life = 0.0, [], True
        for _ in range(3):
            out = bd.birth_death(*state, dt, **consts)
            ref = bd.birth_death_torch(*state, dt, **consts)
            cpu = bd.birth_death_torch(*(t.cpu() for t in state), dt.cpu(), **consts)
            torch.cuda.synchronize()
            err = max(err, check_bd_outputs(f"birth_death kernel vs twin, N={n}", out, ref))
            check_bd_outputs(f"birth_death twin on the card vs the CPU, N={n}", ref, cpu,
                             lifetime_ulps=0.0)
            same_life = same_life and torch.equal(out[6], ref[6])
            deaths.append(int(out[9].sum()))
            state = list(out[:9])

        def kernel():
            return bd.birth_death(*state, dt, **consts)

        def twin():
            return bd.birth_death_torch(*state, dt, **consts)

        ms, eager_ms, plain_ms = device_ms(kernel), time_ms(kernel), device_ms(twin)
        # the timed call's own deaths set the bytes it must read
        timed_deaths = int(kernel()[9].sum())
        nbytes = (4 * (BD_LIVE_READS * (n - timed_deaths) + BD_DEAD_READS * timed_deaths
                       + BD_WRITES * n) + n)
        bound = bound_ms(nbytes)
        rows[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bound_by="bytes", library_ms=None)
        print(f"8a birth_death: N={n}, 3 chained calls of dt {BD_DT}: deaths {deaths} (the "
              f"timed call {timed_deaths}); key, "
              f"births, dead mask, x, y, k, l, sign, age bit-equal to the twin, lifetimes "
              f"bit-equal {same_life} (limit 1 ulp), max |kernel - twin| {err:.3e}; the twin "
              f"on the card bit-equal to the twin on the CPU; kernel {ms:.4f} ms ({eager_ms:.4f} "
              f"ms eager: the wrapper's host work), twin "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s); "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return rows


def phase_hero_bd(card: str, device, rk4_rate: float, nx: int = 512,
                  sqrtp: int = 512) -> tuple[dict, object]:
    """8b: hero_bd (bench.py:202) through CoupledDriver with its launches
    counted from 0: 512^2 RSW, 262,144 lattice packets, bilinear bf16
    tables, IF-AB3, RK4, Weibull(1.5, 10) birth/death seeded 0, 4 frames of
    5 steps at the hero's DT; exactly 20 table and 20 birth/death kernel
    runs on the card, births within 5 sigma of N T E[1/L] -> (its numbers, the driver)."""
    import math

    from juliaraytracingsw_tpu_torch.ops import birth_death, ray_step

    ray_step.reset_launches()
    birth_death.reset_launches()
    res, drv = hero(card, device, "bilinear", spinup_steps=0, n_frames=4, sqrtp=sqrtp,
                    driver_kw=HERO_BD, tag="hero_bd", nx=nx)
    torch.cuda.synchronize()
    check_rows([res], ["hero_bd"])
    n, T = drv.sim.packets.n, float(drv.sim.clock.t)
    births = int(drv.sim.bd.births)
    # staggered ages: a packet of lifetime L dies within T with chance T / L
    expected = n * T * math.gamma(1.0 - 1.0 / BD_CONSTS["k_shape"]) / BD_CONSTS["lam"]
    sigma = math.sqrt(expected)
    print(f"8b hero_bd: {res['coupled_steps_per_s']:.2f} coupled steps/s, "
          f"{res['coupled_steps_per_s'] / rk4_rate:.3f}x phase 4's RK4 hero (1,048,576 "
          f"packets); table kernel runs {res['launches']}, birth_death runs "
          f"{res['bd_launches']}; births in {drv.sim.clock.step} steps {births} (expected "
          f"N T E[1/L] = {expected:.1f} +- 5 sigma {5 * sigma:.1f}); mean age "
          f"{float(drv.sim.bd.age.mean()):.4f} [{card}]", flush=True)
    if res["launches"] != 20 or res["bd_launches"] != 20:
        raise AssertionError(f"hero_bd ran {res['launches']} table and "
                             f"{res['bd_launches']} birth/death kernels, not 20 and 20")
    if abs(births - expected) > 5 * sigma:
        raise AssertionError(f"hero_bd: {births} births, expected {expected:.1f}")
    return res, drv


def phase_bd_checkpoint_on_cpu(card: str, gpu_drv) -> None:
    """8c: the card's hero_bd state written as a JAX-format checkpoint,
    restored into the same driver on the CPU; one more frame on each: every
    birth/death leaf bit-equal (lifetimes within 1 ulp: the card's and the
    CPU's float64 log and pow)."""
    from juliaraytracingsw_tpu_torch.coupled.driver import CoupledDriver
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    t0 = time.perf_counter()
    grid, model, sol0, rp, psih_fn = make_case(gpu_drv.model.grid.nx, "bilinear", "bfloat16",
                                               "cpu")
    cpu_drv = CoupledDriver(model=model, psih_fn=psih_fn, rp=rp, dt=DT, stepper="IFMAB3",
                            k_cutoff=K_CUTOFF, k0=K0, log_fn=lambda line: None, **HERO_BD)
    sqrtp = int(round(gpu_drv.sim.packets.n ** 0.5))
    cpu_drv.init(sol0, lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True,
                                       device="cpu"))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "hero_bd.npz")
        gpu_drv.checkpoint(path)
        with np.load(path) as data:
            paths = bytes(data["__treepaths__"]).decode().split("\n")
            key_dtype = data[f"leaf_{paths.index('.bd.key')}"].dtype
        cpu_drv.restore(path)
    if paths[-4:] != [".bd.age", ".bd.lifetime", ".bd.key", ".bd.births"] or key_dtype != np.uint32:
        raise AssertionError(f"hero_bd checkpoint: leaves {paths[-4:]}, key {key_dtype}")
    for drv in (gpu_drv, cpu_drv):
        drv.run(n_frames=1, flow_steps_per_frame=5)
    g, c = gpu_drv.sim.bd, cpu_drv.sim.bd
    same = {name: torch.equal(getattr(g, name).cpu(), getattr(c, name))
            for name in ("age", "key", "births", "lifetime")}
    ulps = max_ulps(g.lifetime, c.lifetime)
    pk_err = max(float((getattr(gpu_drv.sim.packets, n).cpu()
                        - getattr(cpu_drv.sim.packets, n)).abs().max()) for n in "xykl")
    print(f"8c hero_bd checkpoint (JAX format, key uint32[2]) restored on the CPU, one more "
          f"frame on each: bit-equal {same}, lifetimes {ulps:.1f} ulps apart; births "
          f"{int(g.births)}; packets max abs diff {pk_err:.3e} (bf16 tables); "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if not (same["age"] and same["key"] and same["births"] and ulps <= 1.0):
        raise AssertionError("hero_bd: the CPU's next frame differs from the card's")


def steady_argv(out_dir: str, platform: str = "cuda", nx: int = 512, sqrtp: int = 1024,
                frames: int = 2, substeps: int = 20) -> list[str]:
    """steady-raytracing at nx^2 x sqrtp^2 with 'auto' gather, bilinear bf16
    tables and an --output-dt of ``substeps`` CFL steps a frame."""
    dt = 0.1 / 2.0 * (2 * np.pi / nx)         # derive_dt at the default tune
    output_dt = substeps * dt
    return ["steady-raytracing", "--nx", str(nx), "--sqrt-npackets", str(sqrtp),
            "--interp", "bilinear", "--table-dtype", "bfloat16", "--gather", "auto",
            "--output-dt", repr(output_dt), "--T", repr(frames * output_dt), "--seed", "1",
            "--out-dir", out_dir, "--platform", platform]


def phase_steady_raytracing(card: str, platform: str = "cuda", nx: int = 512,
                            sqrtp: int = 1024) -> dict:
    """8d: steady-raytracing through the command line at 512^2 x 1,048,576
    with a packet writer that drops the frames on the host, launches
    counted from 0: 'auto' -> patch, exactly 40 table launches (2 frames of
    20 substeps), none of birth/death; the whole call timed by CUDA
    events."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.ops import birth_death, ray_step

    with tempfile.TemporaryDirectory() as d:
        args = cli.build_parser().parse_args(steady_argv(d, platform, nx, sqrtp))
        lines = []
        ray_step.reset_launches()
        birth_death.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        packets, t = cli.steady_raytracing(args, DiscardingWriter(), log_fn=lines.append)
        end.record()
        torch.cuda.synchronize()
        counts = launch_counts()
    seconds = start.elapsed_time(end) / 1e3
    n = packets.n
    launches = counts["table"]["bilinear"]
    finite = all(bool(torch.isfinite(a).all()) for a in packets)
    print(f"8d steady-raytracing ({nx}^2, {n} packets, 2 frames of 20 substeps, --gather auto "
          f"-> patch, packet frames copied to the host and dropped): {n * launches / seconds:.4e} "
          f"packet-substeps/s, {2 * n / seconds:.4e} packet-frames/s over the whole call ({seconds:.3f} s: "
          f"set-up, 2 frames, their host copies); table kernel launches {launches}, "
          f"birth_death launches {birth_death.launches['birth_death']}; finite {finite}; "
          f"{lines[-1]} [{card}]", flush=True)
    if (launches != 40 or counts["first cut"] or birth_death.launches["birth_death"]
            or any(v for k, v in counts["table"].items() if k != "bilinear")):
        raise AssertionError(f"steady-raytracing launched {counts}, not 40 table kernels")
    if not finite:
        raise AssertionError("steady-raytracing: non-finite packets")
    return dict(launches=launches, seconds=seconds)


def rel_diff(gpu: torch.Tensor, cpu: torch.Tensor) -> float:
    return float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())


def phase_new_paths_gpu_vs_cpu(card: str, device) -> None:
    """8e: each new path on the card against the CPU, within phase 3's
    limits: a 128^2 x 16,384 birth/death frame (and its population, as 8c
    holds it), nufft_raytrace at 64^2 x 4,096, raytrace1d rk4 and midpoint
    at 4,096 rays, 5 forced RSW steps; then benchmark_integrators' times."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (band_geo_wave_ic,
                                                                        random_band_psih)
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.models.base import build_stepper, run
    from juliaraytracingsw_tpu_torch.rays import nufft_rays, ray1d
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams

    t0 = time.perf_counter()
    gpu_cpu = [coupled_frame(dev, birth_death=dict(k_shape=1.5, lam=0.05))[1]
               for dev in (device, "cpu")]
    g, c = gpu_cpu
    sol_err = rel_diff(g.sol, c.sol)
    pk_err = max(float((getattr(g.packets, n).cpu() - getattr(c.packets, n)).abs().max())
                 for n in "xykl")
    bd_same = all(torch.equal(getattr(g.bd, n).cpu(), getattr(c.bd, n))
                  for n in ("age", "key", "births"))
    life_ulps = max_ulps(g.bd.lifetime, c.bd.lifetime)
    print(f"8e birth/death frame GPU vs CPU (128^2, 16384 packets, 5 steps, lam 0.05): births "
          f"{int(g.bd.births)}; sol rel err {sol_err:.3e} (limit {FRAME_SOL_RTOL}), packet max "
          f"abs err {pk_err:.3e} (limit {FRAME_PACKET_ATOL}); age, key, births bit-equal "
          f"{bd_same}, lifetimes {life_ulps:.1f} ulps apart", flush=True)
    if not (sol_err < FRAME_SOL_RTOL and pk_err < FRAME_PACKET_ATOL and bd_same
            and life_ulps <= 1.0 and int(g.bd.births) > 0):
        raise AssertionError("the birth/death frame differs between the card and the CPU")

    outs = []
    for dev in (device, "cpu"):
        grid = make_grid(64, device=dev)
        rng = np.random.default_rng(3)
        so, sn = (nufft_rays.spectra_from_psih(
            random_band_psih(grid, rng, kband=(2, 6), amp=0.2), grid) for _ in range(2))
        rp = RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                       dy=grid.dy)
        packets = lattice_packets(64, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=dev)
        outs.append(nufft_rays.nufft_raytrace(packets, so, sn, 0.0, 0.02, grid, rp,
                                              nsubsteps=2))
    err = max(float((getattr(outs[0], n).cpu() - getattr(outs[1], n)).abs().max())
              for n in "xykl")
    print(f"8e nufft_raytrace GPU vs CPU (64^2, 4096 packets, 2 RK4 substeps): packet max "
          f"abs err {err:.3e} (limit {FRAME_PACKET_ATOL})", flush=True)
    if not err < FRAME_PACKET_ATOL:
        raise AssertionError("nufft_raytrace differs between the card and the CPU")

    u, ux = ray1d.benchmark_field(512)
    for method in ("rk4", "midpoint"):
        outs = [ray1d.raytrace1d(ray1d.init_rays1d(4096, device=dev),
                                 torch.as_tensor(u, dtype=torch.float32, device=dev),
                                 torch.as_tensor(ux, dtype=torch.float32, device=dev),
                                 1e-3, 200, 2 * np.pi, method) for dev in (device, "cpu")]
        err = max(rel_diff(a, b) for a, b in zip(*outs))
        print(f"8e raytrace1d {method} GPU vs CPU (4096 rays, 200 steps of 1e-3): max rel err "
              f"{err:.3e} (limit {FRAME_SOL_RTOL})", flush=True)
        if not err < FRAME_SOL_RTOL:
            raise AssertionError(f"raytrace1d {method} differs between the card and the CPU")

    outs = []
    for dev in (device, "cpu"):
        grid = make_grid(64, device=dev)
        Fh = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 64, 33))
                             .astype(np.complex64) * 0.3, device=dev)
        model = rsw.make_model(grid, nu=1e-8, nnu=4, f=F, Cg=CG,
                               forcing=lambda sol, t, Fh=Fh: Fh * torch.cos(5.0 * t))
        sol = band_geo_wave_ic(grid, np.random.default_rng(1), ag=0.5, aw=0.05, f=F, Cg=CG)
        init, step = build_stepper(model, "IFMAB3", DT)
        outs.append(run(step, sol, zero_clock(device=dev), init(sol), 5)[0])
    err = rel_diff(*outs)
    print(f"8e forced RSW, 5 IF-AB3 steps GPU vs CPU (64^2): sol rel err {err:.3e} (limit "
          f"{FRAME_SOL_RTOL})", flush=True)
    if not err < FRAME_SOL_RTOL:
        raise AssertionError("the forced RSW steps differ between the card and the CPU")

    times = ray1d.benchmark_integrators(device=device)
    print(f"8e benchmark_integrators (4096 rays, 1000 steps through a 512-point field, CUDA "
          f"events after a warm-up): " + ", ".join(f"{m} {s:.4f} s" for m, s in times.items())
          + f"; phase 8e {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


# phase 9: parallel/ on a mesh of one process over NCCL (make_mesh: a
# world-size-1 group on a FileStore). P > 1 cannot run on one card (NCCL
# refuses two ranks on one device): the multi-rank checks are the CPU
# tests' (gloo, tests/test_torch_parallel.py, test_torch_sharded_*.py).
SLAB_SHAPE = (7, 512, 512)
SLAB_RTOL = 1e-5
# the JAX tests' limits for a sharded run against a replicated one
SHARDED_SOL_ATOL, SHARDED_SOL_RTOL = 2e-5, 2e-4     # atol x max|sol|
SHARDED_PACKET_RTOL, SHARDED_PACKET_ATOL = 5e-4, 5e-5
OVERLAP_RTOL, OVERLAP_ATOL = 1e-6, 1e-7


def sharded_close(got, want, what: str, packets: bool = False) -> float:
    """Assert the JAX tests' limits -> the largest |got - want| over the
    largest |want|."""
    got, want = got.cpu(), want.cpu()
    if packets:
        ok = torch.allclose(got, want, rtol=SHARDED_PACKET_RTOL, atol=SHARDED_PACKET_ATOL)
    else:
        scale = float(want.abs().max())
        ok = torch.allclose(got, want, rtol=SHARDED_SOL_RTOL, atol=SHARDED_SOL_ATOL * scale)
    if not ok:
        raise AssertionError(f"{what}: the sharded run and the replicated one disagree")
    return float((got - want).abs().max() / want.abs().max())


def phase_slab_fft(card: str, mesh, shape=SLAB_SHAPE) -> None:
    """9a: the slab FFT of a (7, 512, 512) field on the mesh against
    torch.fft on the card, and its round trip; all_to_all calls per
    transform; both timed with CUDA events."""
    from juliaraytracingsw_tpu_torch.parallel.fft import slab_irfft2, slab_rfft2

    field = torch.as_tensor(np.random.default_rng(9).standard_normal(shape).astype(np.float32),
                            device=mesh.device)
    calls0 = mesh.counts["all_to_all"]
    spec = slab_rfft2(field, mesh)
    fwd_calls = mesh.counts["all_to_all"] - calls0
    back = slab_irfft2(spec, shape[-1], mesh)
    inv_calls = mesh.counts["all_to_all"] - calls0 - fwd_calls
    ref = torch.fft.rfft2(field)
    err = float((spec[..., :ref.shape[-1]] - ref).abs().max() / ref.abs().max())
    trip = float((back - field).abs().max() / field.abs().max())
    pad = float(spec[..., ref.shape[-1]:].abs().max()) if spec.shape[-1] > ref.shape[-1] else 0.0
    ms = {name: min(events_ms(fn, warmup=2, trials=5)) for name, fn in (
        ("slab_rfft2", lambda: slab_rfft2(field, mesh)),
        ("torch.fft.rfft2", lambda: torch.fft.rfft2(field)),
        ("slab_irfft2", lambda: slab_irfft2(spec, shape[-1], mesh)),
        ("torch.fft.irfft2", lambda: torch.fft.irfft2(ref, s=shape[-2:])))}
    print(f"9a slab FFT of a {shape} float32 field on a mesh of {mesh.size} "
          f"({torch.distributed.get_backend()}): against torch.fft.rfft2 rel err {err:.3e} "
          f"(limit {SLAB_RTOL}), round trip rel err {trip:.3e} (limit {SLAB_RTOL}), pad "
          f"columns max {pad}; all_to_all calls per transform: forward {fwd_calls}, inverse "
          f"{inv_calls}; ms (min of 5, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" [{card}]", flush=True)
    if not (err < SLAB_RTOL and trip < SLAB_RTOL and pad == 0.0
            and fwd_calls == inv_calls == 1):
        raise AssertionError("9a: the slab FFT failed its checks")


def phase_hero_sharded(card: str, mesh, replicated_ray_steps_per_s: float, nx: int = 512,
                       sqrtp: int = 1024, spinup_steps: int = 200, n_frames: int = 4) -> dict:
    """9b: hero_sharded1 (``bench.py:226-254``): ShardedRSW at the hero's
    size on the mesh, phase 4's IC spun up ``spinup_steps`` sharded steps,
    ``n_frames`` frames of 5 coupled steps; exactly 5 table launches and
    5 pair-table launches a frame and no first-cut launch; every frame finite, |k| < k_cutoff,
    energy within 1%; the first frame against the replicated
    ``coupled/driver.make_coupled_frame`` from the same state (run after
    the count is read). Ray-steps/s over the last 3 frames (CUDA events)
    and its ratio to phase 4's. 9c: ``overlap=True`` against the
    sequential frame from the end state."""
    from juliaraytracingsw_tpu_torch.core.steppers import AB3State, zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.ops import pair_table, ray_step
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets, shard_packets
    from juliaraytracingsw_tpu_torch.parallel.sharded_rsw import ShardedRSW
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    device = mesh.device
    grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "bfloat16", device)
    sh = ShardedRSW(grid, model.params, mesh, dt=DT)
    init_fn, step_fn = sh.stepper()
    sol, clock = sh.shard_solution(sol0), zero_clock(device=device)
    state = init_fn(sol)
    for _ in range(spinup_steps):
        sol, clock, state = step_fn(sol, clock, state)
    pk = shard_packets(lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0, k_ring=True,
                                       device=device), mesh)
    frame = sh.make_coupled_frame(rp, 5, k_cutoff=K_CUTOFF, k0=K0)
    start = (sol, clock, state, pk)
    e0 = float(rsw.total_energy(sh.unshard(sol), grid, model.params))
    ray_step.reset_launches()
    pairs0 = pair_table.pair_table_launches["bilinear"]
    first_cut0 = launch_counts()["first cut"]
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[-1].record()
    checks, first = [], None
    for _ in range(n_frames):
        sol, clock, state, pk = frame(sol, clock, state, pk)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        first = first or (sol, pk)
        checks.append((sh.unshard(sol), torch.sqrt(pk.k ** 2 + pk.l ** 2).max()))
    torch.cuda.synchronize()
    launches = ray_step.table_launches["bilinear"]
    others = {k: v for k, v in ray_step.table_launches.items() if k != "bilinear"}
    pairs = pair_table.pair_table_launches["bilinear"] - pairs0
    first_cut = launch_counts()["first cut"] - first_cut0
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    steady = frame_ms[1:] or frame_ms
    rate = 5 * len(steady) / (sum(steady) / 1e3)
    n = sqrtp * sqrtp
    finite = all(bool(torch.isfinite(s.abs()).all()) for s, _ in checks)
    kmax = max(float(k) for _, k in checks)
    dE = max(abs(float(rsw.total_energy(s, grid, model.params)) - e0) / e0 for s, _ in checks)

    # the first frame against the replicated frame from the same state
    sol_s, clock_s, state_s, pk_s = start
    full = sh.unshard(sol_s)
    init_r, step_r = build_stepper(model, "IFMAB3", DT)
    ref = make_coupled_frame(model, step_r, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0)(
        SimState(full, clock_s, AB3State(sh.unshard(state_s.N1), sh.unshard(state_s.N2)),
                 gather_packets(pk_s, mesh), fields_from_psih(psih_fn(full), grid, rp.interp)))
    sol_err = sharded_close(sh.unshard(first[0]), ref.sol, "9b sol")
    got_pk = gather_packets(first[1], mesh)
    pk_err = max(sharded_close(getattr(got_pk, c), getattr(ref.packets, c), f"9b packets.{c}",
                               packets=True) for c in "xykl")
    res = dict(launches=launches, pair_launches=pairs, first_cut=first_cut, frame_ms=frame_ms,
               coupled_steps_per_s=rate, ray_steps_per_s=rate * n,
               vs_replicated=rate * n / replicated_ray_steps_per_s, kmax=kmax, dE=dE,
               finite=finite, collectives=dict(mesh.counts))
    print(f"9b hero_sharded1 (ShardedRSW {nx}^2 on a mesh of {mesh.size}, {n} packets, "
          f"bilinear bf16 tables, {spinup_steps} sharded spinup steps, {n_frames} frames x 5): "
          f"{rate:.2f} coupled steps/s, {res['ray_steps_per_s']:.4e} ray-steps/s over the "
          f"last {len(steady)} frames (frame ms {', '.join(f'{m:.2f}' for m in frame_ms)}); "
          f"hero_sharded1_vs_replicated {res['vs_replicated']:.3f} (phase 4: "
          f"{replicated_ray_steps_per_s:.4e}); table kernel launches {launches}, pair-table "
          f"launches {pairs}, first-cut "
          f"{first_cut}; first frame vs the replicated frame: sol rel err {sol_err:.3e}, "
          f"packets rel err {pk_err:.3e}; max |k| {kmax:.3f} (cutoff {K_CUTOFF}); energy "
          f"change {dE:.3e}; finite {finite}; collectives so far {dict(mesh.counts)} "
          f"[{card}]", flush=True)
    if launches != 5 * n_frames or pairs != 5 * n_frames or first_cut or any(others.values()):
        raise AssertionError(f"9b: launched {launches} bilinear table kernels ({others} "
                             f"others, {first_cut} first cut) and {pairs} pair-table "
                             f"kernels, not {5 * n_frames} each")
    if not (finite and kmax < K_CUTOFF and dE < 0.01):
        raise AssertionError("9b: hero_sharded1 failed its checks")

    # 9c: the pipelined frame against the sequential one
    overlap = sh.make_coupled_frame(rp, 5, k_cutoff=K_CUTOFF, k0=K0, overlap=True)
    outs = [f(sol, clock, state, pk) for f in (frame, overlap)]
    (sa, _, _, pa), (sb, cb, _, pb) = outs
    same_sol = torch.equal(sa, sb)
    ok = all(torch.allclose(b, a, rtol=OVERLAP_RTOL, atol=OVERLAP_ATOL) for a, b in zip(pa, pb))
    ms = {name: min(events_ms(lambda f=f: f(sol, clock, state, pk), warmup=1, trials=3))
          for name, f in (("sequential", frame), ("overlap", overlap))}
    print(f"9c overlap=True against the sequential frame from the end state (5 steps): sol "
          f"bit-equal {same_sol}, packets within rtol {OVERLAP_RTOL} atol {OVERLAP_ATOL} "
          f"{ok}; frame ms (min of 3, CUDA events): sequential {ms['sequential']:.2f}, "
          f"overlap {ms['overlap']:.2f} (a mesh of 1: its gather is a local copy) [{card}]",
          flush=True)
    if not (same_sol and ok and cb.step == clock.step + 5):
        raise AssertionError("9c: the overlap frame differs from the sequential frame")
    res["overlap_ms"] = ms
    return res


def phase_sharded_cli(card: str, device, out_dir: str, nx_rsw: int = 128, sqrtp: int = 128,
                      nx_two: int = 256, nx_ty: int = 128) -> dict:
    """9d: the command line's ``--sharded`` path (``experiments.__main__.
    make_sharded``/``run_sharded``, no writers: the card's machine has no
    h5py): ``rsw`` at 128^2 x 16,384 packets, 2 frames, ``--checkpoint``,
    restored on the CPU by the replicated port, whose next frame agrees
    with the sharded run's next frame on the card (phase 3's limits);
    ``twolayer`` at 256^2 with taps and ``thomasyamada`` at 128^2 (IF-AB3)
    against the replicated port on the card (the JAX tests' limits)."""
    from juliaraytracingsw_tpu_torch.core.steppers import AB3State
    from juliaraytracingsw_tpu_torch.coupled import ty_driver
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import ty_initial_condition
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.io.checkpoint import load_checkpoint
    from juliaraytracingsw_tpu_torch.models import thomasyamada
    from juliaraytracingsw_tpu_torch.ops import ray_step
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets, make_mesh
    from juliaraytracingsw_tpu_torch.parallel.sharded import ShardedThomasYamada
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    quiet = lambda line: None   # noqa: E731
    platform = torch.device(device).type

    def sharded_run(argv):
        args = cli.build_parser().parse_args(argv)
        case = cli.SETUPS[args.cmd](args, quiet)
        cli._check_sharded_options(args)
        sh = cli.make_sharded(args, case, make_mesh(device=case.model.grid.device))
        return args, case, cli.run_sharded(args, case, sh, log_fn=quiet)

    ckpt = os.path.join(out_dir, "sharded.npz")
    argv = coupled_argv("rsw", nx_rsw, sqrtp, 2, "--table-dtype", "float32", *HERO_IC,
                        "--sharded", "--checkpoint", ckpt, platform=platform)
    ray_step.reset_launches()
    args, case, res = sharded_run(argv)
    torch.cuda.synchronize()
    rsw_launches = ray_step.table_launches["bilinear"]
    # one more frame on the card, and from the checkpoint on the CPU
    sh = res.sh
    frame = sh.make_coupled_frame(case.rp, 5, k_cutoff=K_CUTOFF, k0=K0)
    sol_g, _, _, pk_g = frame(res.sol, res.clock, res.state, res.packets)
    cpu_args = cli.build_parser().parse_args(argv + ["--platform", "cpu"])
    cpu_case = cli.setup_rsw(cpu_args, quiet)
    drv = cli.make_driver(cpu_args, cpu_case, log_fn=quiet)
    like = {"sol": cpu_case.sol0, "clock": zero_clock(device="cpu"),
            "N1": cpu_case.sol0, "N2": cpu_case.sol0, "packets": cpu_case.packets}
    tree = load_checkpoint(ckpt, like)
    drv.sim = SimState(tree["sol"], tree["clock"], AB3State(tree["N1"], tree["N2"]),
                       tree["packets"],
                       fields_from_psih(cpu_case.psih_fn(tree["sol"]), cpu_case.model.grid,
                                        cpu_case.rp.interp))
    drv.run(1, 5)
    sol_err = rel_err(sh.unshard(sol_g), drv.sim.sol)
    got = gather_packets(pk_g, sh.mesh)
    pk_err = max(float((getattr(got, c).cpu() - getattr(drv.sim.packets, c)).abs().max())
                 for c in "xykl")
    print(f"9d rsw --sharded ({nx_rsw}^2, {sqrtp * sqrtp} packets, f32 tables, 2 frames, "
          f"--gather auto -> {case.rp.gather}): table kernel launches {rsw_launches}; its "
          f"checkpoint ({os.path.getsize(ckpt) / 2**20:.2f} MiB, the unsharded tree) restored "
          f"on the CPU by the replicated port: the next frame's sol rel err {sol_err:.3e} "
          f"(limit {FRAME_SOL_RTOL}), packet max abs err {pk_err:.3e} (limit "
          f"{FRAME_PACKET_ATOL}) [{card}]", flush=True)
    if not (rsw_launches == 10 and case.rp.gather == "patch" and sol_err < FRAME_SOL_RTOL
            and pk_err < FRAME_PACKET_ATOL):
        raise AssertionError("9d: rsw --sharded failed its checks")

    # twolayer with taps: no table launch; against the replicated port
    two = coupled_argv("twolayer", nx_two, 64, 2, platform=platform, gather="taps")
    ray_step.reset_launches()
    _, two_case, two_res = sharded_run(two + ["--sharded"])
    torch.cuda.synchronize()
    two_launches = sum(ray_step.table_launches.values())
    rep = drive_cli(two, quiet)[0].sim
    two_sol = sharded_close(two_res.sh.unshard(two_res.sol), rep.sol, "9d twolayer sol")
    got = gather_packets(two_res.packets, two_res.sh.mesh)
    two_pk = max(sharded_close(getattr(got, c), getattr(rep.packets, c),
                               f"9d twolayer packets.{c}", packets=True) for c in "xykl")

    # thomasyamada: the sharded phase against the replicated one, IF-AB3
    ty_args = cli.build_parser().parse_args(["thomasyamada", "--nx", str(nx_ty), "--platform",
                                             platform])
    cfg = cli.setup_thomasyamada(ty_args, quiet)
    cfg.stepper, cfg.log_fn = "IFMAB3", quiet
    grid = make_grid(nx_ty, Lx=cfg.Lx, device=device)
    sol0 = ty_initial_condition(grid, np.random.default_rng(cfg.seed), cfg.k0g_range,
                                cfg.k0w_range, cfg.at, cfg.ag, cfg.aw)
    model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    tsh = ShardedThomasYamada(grid, model.params, make_mesh(device=device), dt=cfg.dt)
    outs = []
    for sharded in (True, False):
        diags = {k: [] for k in ty_driver.DIAG_KEYS}
        if sharded:
            s, c = ty_driver._phase_sharded(tsh, cfg, tsh.shard_solution(sol0),
                                            zero_clock(device=device), cfg.dt, 20, 10, None,
                                            diags, "main", time.time())
            s = tsh.unshard(s)
        else:
            s, c = ty_driver._phase(model, cfg, sol0, zero_clock(device=device), cfg.dt, 20,
                                    10, None, diags, "main", time.time())
        outs.append((s, diags))
    ty_sol = sharded_close(outs[0][0], outs[1][0], "9d thomasyamada sol")
    print(f"9d twolayer --sharded ({nx_two}^2, 4096 packets, taps, 2 frames): table "
          f"launches {two_launches}; against the replicated port on the card sol rel err "
          f"{two_sol:.3e}, packets rel err {two_pk:.3e}; thomasyamada sharded ({nx_ty}^2, "
          f"IF-AB3, 20 steps in 2 chunks) against the replicated phase: sol rel err "
          f"{ty_sol:.3e}, wave KE {outs[0][1]['wave_ke'][-1]:.6e} / "
          f"{outs[1][1]['wave_ke'][-1]:.6e} (limits atol {SHARDED_SOL_ATOL} x max|sol|, "
          f"rtol {SHARDED_SOL_RTOL}; packets rtol {SHARDED_PACKET_RTOL}, atol "
          f"{SHARDED_PACKET_ATOL}) [{card}]", flush=True)
    if two_launches or two_case.rp.gather != "taps":
        raise AssertionError("9d: twolayer --sharded with taps launched a table kernel")
    return dict(rsw_launches=rsw_launches)


def phase_parallel(card: str, device, replicated_ray_steps_per_s: float) -> dict:
    """Phase 9 on a mesh of one process over NCCL -> launches and rates."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh(device=device)
    print(f"phase 9: parallel/ on a mesh of {mesh.size} process over "
          f"{torch.distributed.get_backend()} ({mesh.device}); more ranks cannot share one "
          "card under NCCL, so the multi-rank checks are the CPU tests' (gloo ranks)",
          flush=True)
    phase_slab_fft(card, mesh)
    hero9 = phase_hero_sharded(card, mesh, replicated_ray_steps_per_s)
    with tempfile.TemporaryDirectory() as out_dir:
        cli9 = phase_sharded_cli(card, device, out_dir)
    print(f"phase 9 done in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"hero_sharded1": hero9, "cli": cli9}


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
    # the first cut runs on no main path any more: its rows count phase 2's
    # launches, as the probes' rows count phase 2c's
    ray_step.reset_launches()
    kernels, attempts, tables, table_attempts = phase_kernels(card, device)
    first_cut_counts = dict(ray_step.launches)
    first_cut_attempt_counts = dict(ray_step.attempt_launches)
    pair_rows = phase_pair_table(card, device)
    probe_rows, probe_counts = phase_probes(card, device)
    phase_gpu_vs_cpu(device)
    phase_gpu_vs_cpu(device, "adaptive", HERO_ADAPTIVE)

    # the RK4 main path: every launch counted from here on is the hero's
    ray_step.reset_launches()
    main_run = hero(card, device, "bilinear", spinup_steps=200, n_frames=4)[0]
    if main_run["launches"] != 20:
        raise AssertionError(f"hero launched the table kernel {main_run['launches']} times, "
                             f"not 20")
    rows = [main_run] + [hero(card, device, interp, spinup_steps=0, n_frames=2)[0]
                         for interp in INTERPS[1:]]
    check_rows(rows, INTERPS)
    pair_counts = {interp: res["pair_table_runs"] for interp, res in zip(INTERPS, rows)}
    counts = {interp: res["launches"] for interp, res in zip(INTERPS, rows)}

    # the adaptive main path: its launches are counted from 0 again
    ray_step.reset_launches()
    ad_main = hero(card, device, "bilinear", spinup_steps=0, n_frames=3,
                   ray_method="adaptive", ray_opts=HERO_ADAPTIVE)[0]
    ad_rows = [ad_main] + [hero(card, device, interp, spinup_steps=0, n_frames=1,
                                ray_method="adaptive", ray_opts=HERO_ADAPTIVE)[0]
                           for interp in INTERPS[1:]]
    check_rows(ad_rows, INTERPS)
    attempt_counts = {interp: res["attempt_launches"] for interp, res in zip(INTERPS, ad_rows)}
    if any(ray_step.table_launches.values()) or any(res["launches"] for res in ad_rows):
        raise AssertionError(f"the adaptive path launched RK4 kernels: "
                             f"{ray_step.table_launches}")
    for res in rows + ad_rows:
        # one pair table a coupled step, on both paths
        if res["pair_table_runs"] != res["coupled_steps"]:
            raise AssertionError(f"{res['pair_table_runs']} pair-table kernel runs in "
                                 f"{res['coupled_steps']} coupled steps")
    for res in ad_rows:
        # at least one attempt per coupled step, and one launch per attempt
        if not res["attempt_launches"] == res["attempts"] >= res["coupled_steps"]:
            raise AssertionError(f"adaptive hero: {res['attempt_launches']} attempt "
                                 f"launches for {res['attempts']} attempts in "
                                 f"{res['coupled_steps']} coupled steps")
    adaptive_interval(card, device)

    # phase 5: gradients on the card
    fwd_bwd = phase_substep_backward(card, device)
    phase_gradient_gpu_vs_cpu(device)
    phase_hero_fwd_bwd(card, device)
    phase_long_gradient(card, device)

    # phase 6: the command line; its hero's launches are counted from 0
    with tempfile.TemporaryDirectory() as out_dir:
        cli = phase_cli_hero(card, device, out_dir, main_run["coupled_steps_per_s"])
        phase_resume(card, device)
        phase_restore_on_cpu(card, out_dir, cli.pop("sim"))
    phase_cli_gpu_vs_cpu(card)
    # phase 7: the other flow models; each path's launches counted from 0
    model_launches = phase_models(card, device)
    # phase 8: birth/death, steady-raytracing and the other new paths; the
    # kernel against its twin first, then hero_bd and steady-raytracing,
    # each with the launches counted from 0
    t8 = time.perf_counter()
    bd_rows = phase_birth_death_kernel(card, device)
    hero_bd, hero_bd_driver = phase_hero_bd(card, device, main_run["coupled_steps_per_s"])
    phase_bd_checkpoint_on_cpu(card, hero_bd_driver)
    steady = phase_steady_raytracing(card)
    phase_new_paths_gpu_vs_cpu(card, device)
    print(f"phase 8 done in {time.perf_counter() - t8:.1f} s", flush=True)
    # phase 9: parallel/ on a mesh of one process over NCCL; 9b's and 9d's
    # launches are counted from 0 each
    par = phase_parallel(card, device, main_run["ray_steps_per_s"])
    torch.distributed.destroy_process_group()
    for name, got in (("ray_step table", counts), ("ray_attempt table", attempt_counts)):
        for interp in INTERPS:
            if got[interp] == 0:
                raise AssertionError(f"the {name} {interp} kernel was not launched by "
                                     f"its main path")

    hero_dtype = "bfloat16"     # the table rows of the kernels line: the heroes' dtype
    print(f"card: {card}")
    print(json.dumps({"kernels": [
        {"name": f"ray_step_rk4_table_{interp}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": counts[interp],
         "cli_launches": cli["table_counts"][interp],
         **({"model_launches": model_launches,
             "sharded_launches": {"9b hero_sharded1": par["hero_sharded1"]["launches"],
                                  "9d rsw --sharded": par["cli"]["rsw_launches"]}}
            if interp == "bilinear" else {}),
         "table_dtype": hero_dtype,
         **tables[interp, hero_dtype], "fwd_bwd_ms": fwd_bwd[interp, hero_dtype]}
        for interp in INTERPS] + [
        {"name": f"ray_attempt_dp5_table_{interp}", "route": "cuda", "source": ATTEMPT_SOURCE,
         "replaces": ATTEMPT_REPLACES, "launches": attempt_counts[interp],
         "table_dtype": hero_dtype, **table_attempts[interp, hero_dtype]}
        for interp in INTERPS] + [
        {"name": f"ray_step_rk4_{interp}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": first_cut_counts[interp], **kernels[interp]}
        for interp in INTERPS] + [
        {"name": f"ray_attempt_dp5_{interp}", "route": "cuda", "source": ATTEMPT_SOURCE,
         "replaces": ATTEMPT_REPLACES, "launches": first_cut_attempt_counts[interp],
         **attempts[interp]}
        for interp in INTERPS] + [
        {"name": kernel, "route": "cuda", "source": source, "replaces": replaces,
         "launches": probe_counts[kernel], **probe_rows[kernel]}
        for kernel, (_, _, source, replaces) in PROBE_KERNELS.items()] + [
        {"name": f"pair_table_{interp}_{dtype}", "route": "cuda", "source": PAIR_SOURCE,
         "replaces": PAIR_REPLACES, "launches": pair_counts[interp] if dtype == hero_dtype
         else None, **pair_rows[interp, dtype]}
        for interp in INTERPS for dtype in TABLE_DTYPES] + [
        # no Pallas kernel: the reference's weibull_birth_death is XLA-fused
        {"name": "birth_death", "route": "cuda", "source": BD_SOURCE, "replaces": BD_REPLACES,
         "launches": hero_bd["bd_launches"], "n": 1 << 18, **bd_rows[1 << 18],
         "at_1M": bd_rows[1 << 20]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
