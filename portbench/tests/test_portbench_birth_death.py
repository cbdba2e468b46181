"""Birth/death in the benchmark: the reference's Weibull event against the
port's plain twin on the CPU, and the ``rsw512_bd`` cell at a tiny size run
end to end: sound runs come out correct and see rebirths, the control and
a broken birth/death do not."""
from __future__ import annotations

import copy
import math
from types import SimpleNamespace

import pytest
import torch

from portbench import reference
from portbench.check import judge
from portbench.control import readings
from portbench.inputs import k0_of
from portbench.reference.flow import grid
from portbench.run import run_cell
from portbench.spec import Cell, load_cell

CELL = "rsw512_bd"
NX, N, STEPS = 64, 4096, 20
# a short lifetime, so that a tiny cell's checked frames see rebirths
LAM = 0.05


def _twin_and_reference(seed: int, dt: float):
    """The port's ``weibull_birth_death`` and the reference's event from the
    same start -> per step (program packets, reference rows, dead masks,
    program state, reference state)."""
    from juliaraytracingsw_tpu_torch.rays.packets import Packets
    from juliaraytracingsw_tpu_torch.rays.prng import prng_key
    from juliaraytracingsw_tpu_torch.rays.resample import init_birth_death, weibull_birth_death

    cfg = copy.deepcopy(load_cell(CELL).config)
    cfg["nx"] = NX
    event_mod = reference.find("events", "weibull_birth_death")
    k_shape, lam = event_mod.params(cfg)
    g = grid(NX, cfg["L"], "cpu")
    gen = torch.Generator().manual_seed(seed)
    st = torch.stack([(torch.rand(N, generator=gen) - 0.5) * cfg["L"],
                      (torch.rand(N, generator=gen) - 0.5) * cfg["L"],
                      torch.randn(N, generator=gen) * 20, torch.randn(N, generator=gen) * 20,
                      torch.where(torch.arange(N) % 2 == 0, -1.0, 1.0)]).float()
    bd = init_birth_death(prng_key(seed, device="cpu"), N, k_shape=k_shape, lam=lam)
    event = event_mod.follow(cfg, g, reference.NOMINAL, SimpleNamespace(bd=bd))
    pk, rows = Packets(*st.unbind(0)), st
    amb = torch.zeros(N, dtype=torch.bool)
    t = torch.zeros((), dtype=torch.float32)
    out = []
    for _ in range(STEPS):
        t1 = t + dt
        pk, bd, dead = weibull_birth_death(pk, bd, t1 - t, g.L, g.L, k0_of(cfg),
                                           k_shape=k_shape, lam=lam,
                                           x0=float(g.x0), y0=float(g.x0))
        rows = event(rows, amb, t, t1)
        out.append((torch.stack(list(pk)), rows, dead, bd, dict(event.state)))
        t = t1
    return out, amb


def test_the_reference_event_agrees_with_the_port_twin():
    """Bit-equal over 20 steps: the same rebirths, positions, wavevectors,
    branches, ages, lifetimes and key. Both sides draw the same Threefry
    words and evaluate the same float32 roundings and float64 ``log`` and
    ``pow`` with one libm, so no tolerance is needed (on the card the
    kernel and the reference both take CUDA's float64 ``log`` and ``pow``:
    the cell's limits on ages and lifetimes are exact)."""
    steps, amb = _twin_and_reference(2_147_483_659, 0.05)
    deaths = 0
    for prog, rows, dead, bd, state in steps:
        assert torch.equal(dead, state["dead"])
        assert torch.equal(prog, rows)
        assert torch.equal(bd.age, state["age"]) and torch.equal(bd.lifetime, state["life"])
        assert torch.equal(bd.key.to(torch.int64), state["key"])
        deaths += int(dead.sum())
    assert int(steps[-1][3].births) == deaths > 200
    assert int(amb.sum()) < deaths


def _tiny(lam: float = LAM) -> Cell:
    """``rsw512_bd`` at 32^2 with 256 packets and lifetimes of scale
    ``lam``; everything else as committed."""
    cell = load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["nx"], cfg["packets"]["sqrt_n"] = 32, 16
    cfg["flags"]["--bd-lam"] = lam
    tr = copy.deepcopy(cell.traffic)
    tr["spinup_steps"], tr["check_frames"], tr["trace_frames"] = 20, [1, 4], 6
    return Cell(cell.entry, cell.workload, cfg, tr)


def test_a_sound_run_is_correct_and_sees_rebirths(bench, capsys):
    result, checks = run_cell(_tiny(), bench, 2_147_483_659, 0.3, False, device="cpu")
    assert result["correct"], checks
    err = capsys.readouterr().err
    births = int(err.split("births ")[1].split()[0])
    assert births > 0, err
    assert "weibull_birth_death" in err


def test_a_traced_run_counts_births(bench, capsys):
    result, checks = run_cell(_tiny(), bench, 41, 0.3, True, device="cpu")
    assert result["correct"], checks
    err = capsys.readouterr().err
    assert int(err.split("'births': ")[1].split("}")[0]) > 0, err
    # no kernel runs on the CPU: the roofline reads nothing
    assert "birth_death_roofline" not in result["metrics"]


def test_each_seed_keys_its_own_birth_death():
    """``control`` reads many seeds through one program: each seed starts
    from its own key, as a run with that ``--seed`` does."""
    from juliaraytracingsw_tpu_torch.rays.prng import prng_key
    from juliaraytracingsw_tpu_torch.rays.resample import init_birth_death

    from portbench.cells import Program

    cell = _tiny()
    k_shape, lam = reference.find("events", "weibull_birth_death").params(cell.config)
    prog = Program(cell.config, cell.traffic, 5, "cpu", log_fn=lambda line: None)
    for seed in (5, 2_147_483_659):
        prog.init(seed)
        bd = init_birth_death(prng_key(seed, device="cpu"), prog.sim.packets.x.shape[0],
                              k_shape=k_shape, lam=lam)
        assert torch.equal(prog.sim.bd.key, bd.key) and torch.equal(prog.sim.bd.age, bd.age)


def test_the_control_fails_and_the_program_passes():
    cell = _tiny()
    (row,) = readings(cell, [37], {37}, device="cpu")
    assert row["births"] > 0
    assert judge(row["program"], cell.limits), row
    assert not judge(row["control"], cell.limits), row


def _broken(kind):
    """Birth/death broken where it is produced: the step returns its input
    unchanged; the key never moves on, so every step draws the same; the
    lifetimes are drawn with lam 0.1% too large, or with their core in
    float32; or the new lifetimes are dropped, as a frame that does not
    carry them would."""
    from juliaraytracingsw_tpu_torch.rays import resample

    orig = resample.weibull_birth_death

    def step(p, state, *args, **kw):
        if kind == "unchanged":
            return p, state, torch.zeros_like(p.x, dtype=torch.bool)
        if kind == "wrong_lam":
            kw["lam"] *= 1.001
        out, new, dead = orig(p, state, *args, **kw)
        if kind == "stale_key":
            new = new._replace(key=state.key)
        elif kind == "stale_lifetime":
            new = new._replace(lifetime=state.lifetime)
        return out, new, dead
    return step


def _float32_core(key, n, k_shape, lam, dtype=torch.float32):
    """``ops.birth_death.weibull`` with ``(-log u)^(1/k_shape)`` in float32."""
    from juliaraytracingsw_tpu_torch.ops import birth_death

    u = birth_death.uniform(key, n, dtype, birth_death.LIFE_MIN, 1.0)
    return (-torch.log(u)) ** (1.0 / k_shape) * lam


@pytest.mark.parametrize("kind,gap", [("unchanged", "pos_gap_max"),
                                      ("stale_key", "pos_gap_max"),
                                      ("wrong_lam", "bd_life_gap_max"),
                                      ("float32_core", "bd_life_gap_max"),
                                      ("stale_lifetime", "bd_life_gap_max")])
def test_a_broken_birth_death_is_not_correct(kind, gap, bench, monkeypatch):
    from juliaraytracingsw_tpu_torch.coupled import driver
    from juliaraytracingsw_tpu_torch.ops import birth_death

    if kind == "float32_core":
        monkeypatch.setattr(birth_death, "weibull", _float32_core)
    else:
        monkeypatch.setattr(driver, "weibull_birth_death", _broken(kind))
    result, checks = run_cell(_tiny(), bench, 43, 0.3, False, device="cpu")
    assert not result["correct"], checks
    assert checks[gap][0] > checks[gap][1] or math.isinf(checks[gap][0]), checks
