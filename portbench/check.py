"""How ``correct`` is decided: what the timed path produced, held against
the plain reference.

Two comparisons, each from inputs the reference takes whole:

- **start**: from the benchmark's initial flow, the reference runs every
  flow step of the set-up (the spin-up, the IF-AB3 bootstrap, the warm-up
  frames) and ``start_gap`` compares its state with the program's at the
  end of set-up.
- **window**: the program's state is copied before a frame drawn from the
  seed and after the frame that follows it. The flow is chaotic and the
  window holds thousands of steps, so the reference follows those two
  frames step by step from the copied state: the spectrum, the clock and
  the IF-AB3 history (N at the two steps before). It works out again
  everything the program derives from them: the interpolation fields, the
  tables, the exponentials. After each ray step it applies the packet
  events the configuration lists (``cfg["rays"]["events"]``, each
  ``reference/events/<name>.py``, in that order; none listed: the k-cutoff
  reset); an event takes what state it needs (a birth/death's ages,
  lifetimes and key) from the same copy. ``sol_gap`` compares the spectra
  after the two frames, ``pos_gap_max`` and ``wave_gap_max`` every packet
  (but those an event marked ambiguous: where rounding could decide a
  reset or a death), ``attempts_gap`` the adaptive loop's accepted and
  rejected attempts. An event that keeps state of its own compares it
  too (``gaps_events``: its module's ``gaps``, the program's side read
  from the copy after the frames by its ``observed``). The rays
  interpolate as ``cfg["rays"]["interp"]`` names
  (``reference/interp/<name>.py``).

Gaps (the program's, or the control's, against the reference's):

    sol_gap      |sol - sol_ref| / |sol_ref - sol_start|   (L2 over all modes)
    start_gap    the same over the set-up, from the initial flow
    pos_gap_max  max over packets |(x, y) - (x, y)_ref| / dx
    wave_gap_max max over packets |(k, l) - (k, l)_ref| / |(k, l)_ref|
    attempts_gap |accepted - accepted_ref| + |rejected - rejected_ref|
    an event's   as its module's ``gaps`` defines them
"""
from __future__ import annotations

import math

import torch

from . import reference
from .reference.flow import Flow
from .reference.rays import Rays

__all__ = ["DEFAULT_EVENTS", "Follower", "reference_parts", "gaps_window", "gaps_start",
           "gaps_events", "audit_events", "observed_events", "judge", "packet_rows", "prec_of"]

# the packet events of a configuration that lists none
DEFAULT_EVENTS = ("k_cutoff_reset",)


def prec_of(cfg: dict) -> reference.Prec:
    pr = cfg["precision"]
    return reference.Prec(pr["arith"], pr["table"])


def reference_parts(cfg: dict, here=reference.HERE):
    """(the interpolant's module, [(event name, module)]) that the
    configuration names; a name with no file stops the run."""
    rays = cfg["rays"]
    return (reference.find("interp", rays["interp"], here),
            [(name, reference.find("events", name, here))
             for name in rays.get("events", DEFAULT_EVENTS)])


def packet_rows(pk) -> torch.Tensor:
    """``(5, N)`` [x, y, k, l, sign] of the program's ``Packets``."""
    return torch.stack([pk.x, pk.y, pk.k, pk.l, pk.sign])


class Follower:
    """The reference for one configuration and traffic mix, at precision
    ``p``. ``marked``: the packets each event marked ambiguous in the
    last ``frames``; ``states``: the state of each event that keeps one,
    after them."""

    def __init__(self, cfg: dict, traffic: dict, device, dt: float, nu: float,
                 p: reference.Prec):
        self.cfg, self.traffic, self.dt, self.p = cfg, traffic, dt, p
        self.flow = Flow(cfg, device, dt, nu)
        fl = cfg["flow"]
        interp, self.events = reference_parts(cfg)
        self.rays = Rays(self.flow.g, fl["f"], fl["Cg"], p, interp)
        self.marked: dict = {}
        self.states: dict = {}

    def flow_steps(self, sol, step: int, N1, N2, n: int):
        for _ in range(n):
            sol, N1, N2 = self.flow.step(sol, step, N1, N2, self.p)
            step += 1
        return sol, step, N1, N2

    def frames(self, snap, n_frames: int):
        """Follow ``n_frames`` frames of the traffic mix from the program's
        state ``snap`` -> (sol, st, ambiguous, accepted, rejected)."""
        tr = self.traffic
        sol, step = snap.sol, snap.clock.step
        N1, N2 = snap.stepper_state[0], snap.stepper_state[1]
        t = snap.clock.t
        st = packet_rows(snap.packets)
        amb = torch.zeros(st.shape[1], dtype=torch.bool, device=st.device)
        acc = rej = 0
        spf = tr["steps_per_frame"]
        self.marked, self.states = {}, {}
        if tr["kind"] != "coupled":
            sol, _, _, _ = self.flow_steps(sol, step, N1, N2, n_frames * spf)
            return sol, st, amb, 0, 0
        opts = tr.get("ray_opts") or {}
        events = [(name, mod.follow(self.cfg, self.flow.g, self.p, snap),
                   torch.zeros_like(amb)) for name, mod in self.events]
        F_old = self.rays.tables(self.flow.fields(sol))
        for _ in range(n_frames * spf):
            sol, N1, N2 = self.flow.step(sol, step, N1, N2, self.p)
            step += 1
            t1 = t + self.dt
            F_new = self.rays.tables(self.flow.fields(sol))
            if tr["ray_method"] == "rk4":
                st = self.rays.rk4(st, F_old, F_new, t, t1)
            else:
                st, a, r = self.rays.adaptive(st, F_old, F_new, t, t1, opts["rtol"],
                                              opts["atol"], opts["max_steps"],
                                              opts.get("init_substeps", 4))
                acc, rej = acc + a, rej + r
            for _, event, marks in events:
                st = event(st, marks, t, t1)
            F_old, t = F_new, t1
        for name, event, marks in events:
            amb |= marks
            self.marked[name] = int(marks.sum())
            if hasattr(event, "state"):
                self.states[name] = event.state
        return sol, st, amb, acc, rej

    def setup(self, sol0, steps: int):
        """The flow through the set-up's ``steps`` steps from the initial
        flow."""
        z = torch.zeros_like(sol0)
        return self.flow_steps(sol0, 0, z, z, steps)[0]


def _rel(a, b, base) -> float:
    den = float(torch.linalg.vector_norm(b - base))
    return float(torch.linalg.vector_norm(a - b)) / den if den > 0 else math.inf


def gaps_window(out_sol, out_st, ref, sol_in, dx: float, coupled: bool,
                attempts=None) -> dict:
    """The window's gaps of an output (the program's or the control's)
    against the reference's ``ref`` = (sol, st, ambiguous, acc, rej)."""
    sol_r, st_r, amb, acc_r, rej_r = ref
    gaps = {"sol_gap": _rel(out_sol, sol_r, sol_in)}
    if coupled:
        keep = ~amb
        dpos = torch.hypot(out_st[0] - st_r[0], out_st[1] - st_r[1])[keep]
        dk = torch.hypot(out_st[2] - st_r[2], out_st[3] - st_r[3])[keep]
        kr = torch.hypot(st_r[2], st_r[3])[keep]
        gaps["pos_gap_max"] = float(dpos.max()) / dx if dpos.numel() else math.inf
        gaps["wave_gap_max"] = float((dk / kr).max()) if dk.numel() else math.inf
        if attempts is not None:
            acc, rej = attempts
            gaps["attempts_gap"] = float(abs(acc - acc_r) + abs(rej - rej_r))
    return gaps


def observed_events(ref: Follower, snap) -> dict:
    """The program's side of each event state ``ref`` followed, read from
    its copy ``snap``."""
    mods = dict(ref.events)
    return {name: mods[name].observed(snap) for name in ref.states}


def gaps_events(ref: Follower, ref_out, out_states: dict, out_st) -> dict:
    """The events' own gaps: each state ``ref`` followed (its last
    ``frames``, which gave ``ref_out``) against ``out_states`` (the
    program's ``observed_events``, or the control's ``states``), over the
    packets no event marked."""
    mods, keep = dict(ref.events), ~ref_out[2]
    gaps: dict = {}
    for name, state in ref.states.items():
        gaps.update(mods[name].gaps(out_states[name], state, out_st, ref_out[1], keep))
    return gaps


def audit_events(ref: Follower, ref_out, out_states: dict) -> dict:
    """Each event's ``audit`` of where the two sides' states parted, for
    the readings of its ambiguity window (``control``)."""
    mods, keep = dict(ref.events), ~ref_out[2]
    return {name: mods[name].audit(out_states[name], state, keep)
            for name, state in ref.states.items() if hasattr(mods[name], "audit")}


def gaps_start(out_sol, ref_sol, sol0) -> dict:
    return {"start_gap": _rel(out_sol, ref_sol, sol0)}


def judge(gaps: dict, limits: dict) -> bool:
    """Every gap at or under its limit; a gap with no limit, or not a
    number, fails."""
    return all(name in limits and g <= limits[name] for name, g in gaps.items()) and \
        set(limits) <= set(gaps)
