"""The coupled driver's frames as CUDA graphs (``coupled/driver``).

On the CPU: the rule that decides whether a frame may replay as a graph
(``eager_reason``), the count of eager frames, the ordered copy of a
frame's outputs into its buffers, the buffers cloned from the state, a
caller's state never written, and the whole mechanism against eager
frames with the CUDA graph emulated by an op log (``_OpLogGraph``: every op the capture runs is recorded, its
writes undone, and a replay runs the ops again into the same tensors),
the frames' tail graphs against eager tails for every command line at a
cadence of diagnostics and log lines, and the NaN guard after a graphed
and an eager frame.

On the card (marked ``cuda``, skipped without one): graphed frames held
bit-equal to eager frames over at least three replays at 64^2 and 4,096
packets, for RK4 with the k-cutoff reset, RK4 with birth/death, DP5, the
two-layer RK4 frame on the taps path and the flow frame of each
command-line setup; the tails of RK4 and three-layer frames (the NaN
guard, diagnostics and log scalars, one wait a frame) bit-equal to eager
tails; the adaptive DP5(4) frame, its 'while' loop a WHILE
node of the graph, at 128^2 and 65,536 packets, its steps' infos included;
a restore into a graphed driver; a caller's initial
state left untouched; the table kernel and the pair table's run once a
step (no roll) and the taps gather once a stage by the replays, as a
profiler trace finds them, with no host launch counted. These import no JAX:

    python -m pytest --noconftest -q tests/test_torch_graph_frames.py
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402
from torch_card import cuda_device, kernel_runs, setup_case  # noqa: E402, F401

from juliaraytracingsw_tpu_torch.coupled import driver as drv_mod  # noqa: E402
from juliaraytracingsw_tpu_torch.experiments import __main__ as cli  # noqa: E402
from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import adaptive_loop, pair_table, ray_step  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import interp  # noqa: E402
from juliaraytracingsw_tpu_torch.utils import observability as obs  # noqa: E402

K = 4          # flow steps a frame
FRAMES = 5     # frames after the bootstrap: one eager, one captured, three more replays


def _argv(cmd: str, platform: str, nx: int, sqrtp: int, *extra: str) -> list[str]:
    return [cmd, "--nx", str(nx), "--sqrt-npackets", str(sqrtp), "--interp", "bilinear",
            "--table-dtype", "bfloat16", "--gather", "patch", "--seed", "3",
            "--platform", platform, *extra]


def _driver(cmd: str, platform: str, nx: int, sqrtp: int, *extra: str, **changes):
    """(driver, case) of a command line, the driver changed by ``changes``
    and started from the case's state."""
    args, case = setup_case(_argv(cmd, platform, nx, sqrtp, *extra))
    drv = cli.make_driver(args, case, log_fn=lambda s: None)
    if changes:
        drv = dataclasses.replace(drv, **changes)
    drv.init(case.sol0, case.packets, clock=cli.start_clock(case, case.sol0.device))
    return drv, case


def _copy(sim):
    """A copy of a state that later frames cannot touch."""
    return type(sim)(*(_copy(v) for v in sim)) if isinstance(sim, tuple) else (
        sim.clone() if isinstance(sim, torch.Tensor) else sim)


def _assert_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def _graphed_vs_eager(drv, kind: str, frames: int, k: int = K):
    """Run ``frames`` frames of ``kind`` through the driver and the same
    frames eagerly from a copy of its state, equal after each frame."""
    ref = _copy(drv.sim)
    frame = drv._get_frame(kind, k)
    for _ in range(frames):
        if kind == "coupled":
            drv.run(1, k)
        else:
            drv.spinup(k, chunk=k)
        ref = frame(ref)
        _assert_equal(drv.sim, ref)


# --- the rule ------------------------------------------------------------------

GRAPHS = dict(device="cuda", requires_grad=False, remat=False, ray_method="rk4", step=3,
              calls=1, gather="patch", loop="while")


@pytest.mark.parametrize("change,reason", [
    (dict(device="cpu"), "cpu"),
    (dict(device="cpu", ray_method="adaptive", step=0, calls=0), "cpu"),
    (dict(requires_grad=True), "grad"),
    (dict(remat=True), "grad"),
    # DP5(4)'s 'while' loop over the pair table runs on the device
    (dict(ray_method="adaptive"), None),
    (dict(ray_method="adaptive", gather="taps"), "loop"),
    (dict(ray_method="adaptive", loop="scan"), "loop"),
    (dict(ray_method="adaptive", step=2), "bootstrap"),
    (dict(ray_method="adaptive7"), "loop"),
    (dict(ray_method="adaptive7", gather="taps", loop="scan"), "loop"),
    (dict(ray_method="midpoint"), "loop"),
    (dict(step=2), "bootstrap"),
    (dict(step=0, calls=0), "bootstrap"),
    (dict(calls=0), "first_call"),
    ({}, None),
    (dict(ray_method="dopri5", step=1000, calls=7), None),
    (dict(ray_method=None), None),
], ids=lambda v: repr(v) if isinstance(v, (dict, str, type(None))) else None)
def test_eager_reason(change, reason):
    assert drv_mod.eager_reason(**{**GRAPHS, **change}) == reason
    assert reason is None or reason in obs.GRAPH_REASONS


def test_cpu_driver_counts_eager_cpu_frames():
    drv, _ = _driver("rsw", "cpu", 32, 8)
    obs.reset_graph_frames()
    drv.spinup(6, chunk=3)
    drv.run(3, 2)
    assert obs.graph_frames == {**{key: 0 for key in obs.graph_frames}, "eager.cpu": 5}
    assert not drv._graphs


@pytest.mark.parametrize("case", ["ab3_shift", "view"])
def test_copy_back_reads_each_buffer_first(case):
    n1, n2, sol = (torch.full((3,), float(v)) for v in (1, 2, 3))
    new = torch.full((3,), 4.0)
    # buffers (sol, N1, N2); the outputs N1 <- new, N2 <- N1 (or a view of
    # it), listed in the order that would lose N1
    out = [sol, new, n1 if case == "ab3_shift" else n1.view(1, 3)[0]]
    drv_mod._copy_back([sol, n1, n2], out)
    assert (float(sol[0]), float(n1[0]), float(n2[0])) == (3.0, 4.0, 1.0)


def test_buffers_clone_the_state():
    """A graph's buffers are copies of the state, one for each tensor even
    where the state's tensors alias; the state it returns holds them."""
    drv, case = _driver("rsw", "cpu", 32, 8)
    drv.spinup(4, chunk=4)
    drv.run(1, 1)
    sim = drv.sim
    n1 = sim.stepper_state.N1
    sim = sim._replace(stepper_state=type(sim.stepper_state)(n1, n1))
    graph = drv_mod._FrameGraph(drv._get_frame("coupled", 1), "coupled", 1)
    static = graph.buffers(sim)
    leaves, buffers = drv_mod._carried(sim, "coupled"), drv_mod._carried(static, "coupled")
    assert buffers == graph.static
    ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    assert len({t.untyped_storage().data_ptr() for t in buffers} | ptrs) == len(buffers) + len(ptrs)
    for t, s in zip(leaves, buffers):
        assert torch.equal(t, s)
    assert static.clock.step == sim.clock.step


# --- the mechanism, with the graph emulated on the CPU -------------------------

class _OpLog(TorchDispatchMode):
    """Runs and records every op; undoes each write at the end, as a
    capture runs nothing. Refuses a tensor made from host data
    (``lift_fresh``, as ``t[i] = 1.0`` makes) and a read of a value by the
    host (``float(t)``): on the card a copy from the host or a wait, which
    a CUDA graph cannot hold."""

    def __init__(self, graph):
        super().__init__()
        self.graph, self.saved = graph, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.ops.aten.lift_fresh.default, torch.ops.aten._local_scalar_dense.default):
            raise RuntimeError(f"{func} during a capture")
        for arg, value in zip(func._schema.arguments, args):
            if arg.alias_info is not None and arg.alias_info.is_write:
                self.saved.setdefault(id(value), (value, value.clone()))
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        with torch.no_grad():
            for value, old in self.saved.values():
                value.copy_(old)
        return out


class _OpLogGraph:
    def __init__(self):
        self.ops = []

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for o, n in zip(tree_leaves(out), tree_leaves(new)):
                    if isinstance(o, torch.Tensor) and o is not n:
                        o.copy_(n)


@pytest.fixture
def emulated_graphs(monkeypatch):
    """The driver takes the CPU for a card and a CUDA graph for an op log."""
    decide = drv_mod.eager_reason
    monkeypatch.setattr(drv_mod, "eager_reason",
                        lambda device, *a: decide("cuda", *a))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _OpLogGraph)
    monkeypatch.setattr(torch.cuda, "graph", _OpLog)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    obs.reset_graph_frames()


@pytest.mark.parametrize("cmd,kind,extra,changes,k", [
    ("rsw", "coupled", ("--ray-method", "rk4"), dict(k_cutoff="near"), K),
    ("rsw", "coupled", ("--ray-method", "rk4", "--birth-death", "--bd-lam", "0.05"), {}, K),
    ("rsw", "coupled", ("--ray-method", "dopri5"), {}, K),
    ("rsw", "coupled", ("--ray-method", "rk4"), {}, 1),
    ("rsw", "flow", (), {}, K),
    ("twolayer", "coupled", ("--ray-method", "rk4", "--gather", "taps"), {}, K),
], ids=["rk4_cutoff", "rk4_birth_death", "dopri5", "rk4_one_step", "flow", "twolayer_taps"])
def test_emulated_graph_frames_match_eager(emulated_graphs, cmd, kind, extra, changes, k):
    drv, case = _driver(cmd, "cpu", 32, 8, *extra)
    if changes.get("k_cutoff") == "near":
        drv = dataclasses.replace(drv, k_cutoff=1.0005 * drv.k0)
        drv.init(case.sol0, case.packets)
    sol0, pk0 = _copy(case.sol0), _copy(case.packets)
    drv.spinup(4, chunk=4)
    _graphed_vs_eager(drv, kind, FRAMES, k)
    # a coupled frame's first call runs eager; the flow frame's ran in the spin-up
    assert obs.graph_frames["captured"] == 1
    assert obs.graph_frames["replayed"] == FRAMES - (kind == "coupled")
    _assert_equal(case.sol0, sol0)
    _assert_equal(case.packets, pk0)


def test_caller_state_put_in_place_is_never_written(emulated_graphs):
    """A caller's state put in ``drv.sim`` (its AB3 state shifted into
    place by a 1-step eager frame, then captured and replayed) is never
    written, and the frames match eager frames from a copy of it."""
    drv, _ = _driver("rsw", "cpu", 32, 8, "--ray-method", "rk4")
    drv.spinup(4, chunk=4)
    mine = _copy(drv.sim)
    kept = _copy(mine)
    drv.sim = mine
    _graphed_vs_eager(drv, "coupled", 4, 1)
    assert obs.graph_frames["captured"] == 1 and obs.graph_frames["replayed"] == 3
    _assert_equal(mine, kept)
    drv.sim = mine
    drv.run(1, 1)
    _assert_equal(mine, kept)
    _assert_equal(drv.sim, drv._get_frame("coupled", 1)(kept))


def _tails_run(cmd: str, platform: str, nx: int, sqrtp: int, extra: tuple, frames: int,
               k: int, eager: bool, monkeypatch, **changes):
    """A driver's spin-up, then ``frames`` frames of ``k`` steps in one
    ``run``; with ``eager`` every frame, and so every tail, runs eager ->
    (driver, log lines without their ``wall:``, waits, frame tails)."""
    logs = []
    drv, _ = _driver(cmd, platform, nx, sqrtp, *extra, log_fn=logs.append, **changes)
    drv.spinup(4, chunk=4)
    obs.reset_waits()
    obs.reset_frame_tails()
    with monkeypatch.context() as m:
        if eager:
            m.setattr(drv_mod, "eager_reason", lambda *a: "first_call")
        drv.run(frames, k)
    return drv, [line.split(", wall:")[0] for line in logs], dict(obs.waits), dict(obs.frame_tails)


def _assert_tails_equal(drv, ref, logs, ref_logs):
    """The diagnostics' times and series (dtype, shape and bits) and the
    log lines of two drivers are the same."""
    assert drv.diag_times == ref.diag_times
    assert drv.diag_series.keys() == ref.diag_series.keys()
    for name, series in drv.diag_series.items():
        assert len(series) == len(ref.diag_series[name])
        for a, b in zip(series, ref.diag_series[name]):
            assert (a.dtype, a.shape, a.tobytes()) == (b.dtype, b.shape, b.tobytes()), name
    assert logs == ref_logs


@pytest.mark.parametrize("cmd", sorted(cli.SETUPS))
def test_emulated_graph_tails_match_eager(emulated_graphs, monkeypatch, cmd):
    """Every command line's coupled frames, recorded every 2nd frame and
    logged every 3rd: behind graphed frames the tail graphs give the
    diagnostics and log lines of eager frames, on the same frames, with one
    wait a frame, one tail graph for each set of parts the cadence asks for."""
    cadence = dict(diag_every_frames=2, log_every_frames=3)
    ref, ref_logs, ref_waits, ref_tails = _tails_run(cmd, "cpu", 32, 8, (), 7, 2, True,
                                                     monkeypatch, **cadence)
    drv, logs, waits, tails = _tails_run(cmd, "cpu", 32, 8, (), 7, 2, False, monkeypatch,
                                         **cadence)
    _assert_tails_equal(drv, ref, logs, ref_logs)
    assert np.allclose(drv.diag_times, [drv.dt * s for s in (6, 10, 14, 18)], rtol=1e-5)
    assert [line.split(",")[0] for line in logs] == [f"step: {s:06d}" for s in (6, 12, 18)]
    assert ref_waits == waits == {**dict.fromkeys(obs.WAIT_SITES, 0), "driver.frame_tail": 7}
    assert ref_tails == {"graphed": 0, "eager": 7}
    # the coupled frame's first call runs eager, and its tail with it
    assert tails == {"graphed": 6, "eager": 1}
    graph = drv._graphs[("coupled", 2)]
    assert set(graph.tails) == {(False, False), (True, False), (False, True), (True, True)}


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_nan_guard_stops_the_run_after_the_frame(emulated_graphs, monkeypatch, graphed):
    """A NaN put into the state stops ``run`` after the frame that read it,
    with the frame's index and time, and records and logs nothing of it."""
    drv, _ = _driver("rsw", "cpu", 32, 8, "--ray-method", "rk4")
    drv.spinup(4, chunk=4)
    drv.run(2, K)
    n_diag = len(drv.diag_times)
    sim = drv.sim
    sim.sol[0, 1, 1] = float("nan")
    obs.reset_frame_tails()
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(drv_mod, "eager_reason", lambda *a: "first_call")
        with pytest.raises(FloatingPointError, match=r"^solution is NaN/Inf at frame 0 "
                           rf"\(t={float(drv.sim.clock.t) + K * drv.dt:.3f}\) — aborting$"):
            drv.run(3, K)
    assert obs.frame_tails == {"graphed": int(graphed), "eager": int(not graphed)}
    assert len(drv.diag_times) == n_diag


# --- on the card ---------------------------------------------------------------

NX, SQRTP = 64, 64


@pytest.mark.cuda
def test_rk4_graph_frames_match_eager(cuda_device):
    """RK4 with a k-cutoff that resets packets: bit-equal frames, one
    capture, the table kernel counted once a step, the caller's state
    untouched."""
    drv, case = _driver("rsw", cuda_device, NX, SQRTP, "--ray-method", "rk4")
    drv = dataclasses.replace(drv, k_cutoff=1.0005 * drv.k0)
    drv.init(case.sol0, case.packets)
    sol0, pk0 = _copy(case.sol0), _copy(case.packets)
    obs.reset_graph_frames()
    drv.spinup(4, chunk=4)
    _graphed_vs_eager(drv, "coupled", FRAMES)
    launches = ray_step.table_launches["bilinear"]
    builds = pair_table.pair_table_launches["bilinear"]
    with kernel_runs() as runs:
        drv.run(3, K)
    # the replays run the table kernel and the pair table's once a step,
    # with no host launch, and no roll
    assert runs["table"] == runs["pair table"] == 3 * K and runs["roll"] == 0
    assert ray_step.table_launches["bilinear"] == launches
    assert pair_table.pair_table_launches["bilinear"] == builds
    assert obs.graph_frames == {**{key: 0 for key in obs.graph_frames}, "captured": 1,
                                "replayed": FRAMES + 2, "eager.bootstrap": 1,
                                "eager.first_call": 1}
    reset = (drv.sim.packets.k == drv.k0) & (drv.sim.packets.l == 0)
    assert int(reset.sum()) > int(((pk0.k == drv.k0) & (pk0.l == 0)).sum())
    _assert_equal(case.sol0, sol0)
    _assert_equal(case.packets, pk0)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [("--ray-method", "rk4", "--birth-death", "--bd-lam", "0.05"),
                                   ("--ray-method", "dopri5")],
                         ids=["rk4_birth_death", "dopri5"])
def test_coupled_graph_frames_match_eager(cuda_device, extra):
    drv, _ = _driver("rsw", cuda_device, NX, SQRTP, *extra)
    obs.reset_graph_frames()
    drv.spinup(4, chunk=4)
    _graphed_vs_eager(drv, "coupled", FRAMES)
    assert obs.graph_frames["captured"] == 1
    assert obs.graph_frames["replayed"] == FRAMES - 1
    if drv.birth_death:
        assert int(drv.sim.bd.births) > 0


INFO_KEYS = ("t_reached", "h_final", "n_accepted", "n_rejected")


@pytest.mark.cuda
@pytest.mark.parametrize("rtol,atol,max_steps", [(1e-3, 1e-6, 16), (1e-8, 1e-11, 64),
                                                 (1e-8, 1e-11, 2)],
                         ids=["one_attempt", "rejects", "max_steps_2"])
def test_adaptive_graph_frames_match_eager(cuda_device, rtol, atol, max_steps):
    """DP5(4) in the 'while' loop over bf16 bilinear tables at 128^2 x
    65,536 packets: frames whose loop is a WHILE node of the graph, bit-equal
    to eager frames (the same kernels, the host testing the loop) over four
    replays, each step's info included; at the adaptive hero's tolerances
    one attempt a step, at rtol 1e-8 rejections (3-5 a step from the
    third step on, as on the CPU), and with two slots at most steps that
    stop short of t1 (a rejected first attempt shrinks h below the
    interval), as eager. The capture holds one WHILE node a step;
    no adaptive frame runs eager for its loop."""
    drv, _ = _driver("rsw", cuda_device, 128, 256, "--ray-method", "adaptive",
                     "--ray-rtol", repr(rtol), "--ray-atol", repr(atol),
                     "--ray-max-steps", str(max_steps))
    drv.ray_opts.update(init_substeps=1, loop="while")
    obs.reset_graph_frames()
    drv.spinup(4, chunk=4)
    nodes = adaptive_loop.launches["while_nodes"]
    ref = _copy(drv.sim)
    frame = drv._get_frame("coupled", K)
    decisions = []
    for _ in range(FRAMES):
        drv.run(1, K)
        ref = frame(ref)       # its infos follow the driver's in drv.ray_infos
        _assert_equal(drv.sim, ref)
        graphed, eager = drv.ray_infos[:K], drv.ray_infos[K:]
        assert len(graphed) == len(eager) == K
        for g, e in zip(graphed, eager):
            for key in INFO_KEYS:
                assert g[key].dtype == e[key].dtype and torch.equal(g[key], e[key]), key
        decisions += [(int(i["n_accepted"]), int(i["n_rejected"])) for i in graphed]
    assert obs.graph_frames["captured"] == 1 and obs.graph_frames["replayed"] == FRAMES - 1
    assert obs.graph_frames["eager.loop"] == 0 and obs.graph_frames["eager.first_call"] == 1
    assert adaptive_loop.launches["while_nodes"] == nodes + K
    if max_steps == 16:
        assert decisions == [(1, 0)] * (FRAMES * K)
    elif max_steps == 2:
        assert all(a + r <= 2 for a, r in decisions)
        assert any(r >= 1 and a + r == 2 for a, r in decisions)
    else:
        assert sum(r for _, r in decisions) > 0 and all(a >= 1 for a, _ in decisions)


@pytest.mark.cuda
def test_twolayer_taps_graph_frames_match_eager(cuda_device):
    """Two-layer RK4 frames on the taps path: bit-equal frames, one
    capture, then replays that run the taps gather once a stage with no
    host call (PyTorch runs ``_gather_taps``'s 1-D ``index_select`` as
    its gather kernel)."""
    drv, _ = _driver("twolayer", cuda_device, NX, SQRTP, "--ray-method", "rk4",
                     "--gather", "taps", "--table-dtype", "float32")
    assert drv.rp.gather == "taps"
    obs.reset_graph_frames()
    drv.spinup(4, chunk=4)
    _graphed_vs_eager(drv, "coupled", FRAMES)
    assert obs.graph_frames["captured"] == 1
    assert obs.graph_frames["replayed"] == FRAMES - 1
    gathers = dict(interp.taps_gathers)
    with kernel_runs() as runs:
        drv.run(3, K)
    assert runs["taps gather"] == 4 * 3 * K
    assert interp.taps_gathers == gathers
    assert obs.graph_frames["captured"] == 1
    assert obs.graph_frames["replayed"] == FRAMES + 2


@pytest.mark.cuda
@pytest.mark.parametrize("cmd", sorted(cli.SETUPS))
def test_flow_graph_frames_match_eager(cuda_device, cmd):
    drv, _ = _driver(cmd, cuda_device, NX, SQRTP)
    obs.reset_graph_frames()
    _graphed_vs_eager(drv, "flow", FRAMES + 1)
    assert obs.graph_frames["captured"] == 1
    assert obs.graph_frames["replayed"] == FRAMES
    assert obs.graph_frames["eager.bootstrap"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cmd,extra", [("rsw", ("--ray-method", "rk4")),
                                       ("twolayer", ("--nlayers", "3"))],
                         ids=["rsw_rk4", "three_layers"])
def test_graphed_tails_match_eager(cuda_device, monkeypatch, cmd, extra):
    """One eager frame, then four graphed ones, each tail read in one wait:
    the diagnostics, their times and the log lines (t, cfl) bit-equal to an
    eager-only driver's; the n-layer diagnostics read the model's table, so
    a graph holds them too."""
    ref, ref_logs, _, _ = _tails_run(cmd, cuda_device, NX, SQRTP, extra, 5, K, True,
                                     monkeypatch)
    logs = []
    drv, _ = _driver(cmd, cuda_device, NX, SQRTP, *extra, log_fn=logs.append)
    drv.spinup(4, chunk=4)
    obs.reset_frame_tails()
    for _ in range(5):
        waits = dict(obs.waits)
        drv.run(1, K)
        assert obs.waits == {**waits, "driver.frame_tail": waits["driver.frame_tail"] + 1}
    assert obs.frame_tails == {"graphed": 4, "eager": 1}
    assert set(drv._graphs[("coupled", K)].tails) == {(True, True)}
    _assert_tails_equal(drv, ref, [line.split(", wall:")[0] for line in logs], ref_logs)


@pytest.mark.cuda
def test_restore_into_graphed_driver(cuda_device, tmp_path):
    drv, _ = _driver("rsw", cuda_device, NX, SQRTP, "--ray-method", "rk4")
    drv.spinup(4, chunk=4)
    drv.run(3, K)
    path = str(tmp_path / "state.npz")
    drv.checkpoint(path)
    saved = _copy(drv.sim)
    drv.run(2, K)
    after = _copy(drv.sim)
    obs.reset_graph_frames()
    drv.restore(path)
    _assert_equal(drv.sim, saved)
    drv.run(2, K)
    _assert_equal(drv.sim, after)
    assert obs.graph_frames == {**{key: 0 for key in obs.graph_frames}, "replayed": 2}
