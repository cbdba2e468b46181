"""The system under test, built and driven as its command line builds and
drives it: ``experiments.__main__``'s parser, its ``setup_rsw`` /
``setup_twolayer`` and ``make_driver``, without writers, then
``CoupledDriver.init`` with the benchmark's inputs, ``spinup`` and
``run``. Nothing here computes what the program computes.

A configuration's ``flags`` (long options of the command line, each with
its value; ``true`` a bare flag) follow the model's part of its command
line, in the file's order.
"""
from __future__ import annotations

import torch

from .inputs import initial_flow, packets

__all__ = ["UMAX", "argv", "Program", "snapshot", "copy_into"]

# the command line's velocity scale for its CFL time step (--umax-estimate)
UMAX = 2.0


def _num(x) -> str:
    return repr(float(x))


def _flag(name: str, value) -> list[str]:
    if value is True:
        return [name]
    if isinstance(value, bool):
        raise ValueError(f"flag {name} is false: a bare flag is true, else left out")
    return [name, _num(value) if isinstance(value, float) else str(value)]


def argv(cfg: dict, traffic: dict, seed: int, device: str) -> list[str]:
    """The command line of a configuration under a traffic mix; the CFL
    tune is the one that gives the configuration's dt; the configuration's
    ``flags`` last."""
    flags = [w for name, value in (cfg.get("flags") or {}).items() for w in _flag(name, value)]
    return _model_argv(cfg, traffic, seed, device) + flags


def _model_argv(cfg: dict, traffic: dict, seed: int, device: str) -> list[str]:
    fl, pk, rays = cfg["flow"], cfg["packets"], cfg["rays"]
    dx = cfg["L"] / cfg["nx"]
    common = ["--nx", str(cfg["nx"]), "--L", _num(cfg["L"]),
              "--cfltune", _num(cfg["dt"] * UMAX / dx), "--umax-estimate", _num(UMAX),
              "--nutune", _num(fl["nutune"]), "--nnu", str(fl["nnu"]),
              "--stepper", fl["stepper"], "--seed", str(seed), "--platform", device,
              "--sqrt-npackets", str(pk["sqrt_n"]), "--omega0-over-f", _num(pk["omega0_over_f"]),
              "--interp", rays["interp"], "--table-dtype", rays["table_dtype"],
              "--gather", rays["gather"], "--ray-method", traffic.get("ray_method", "rk4"),
              "--ray-substeps", str(traffic.get("ray_substeps", 1))]
    opts = traffic.get("ray_opts") or {}
    for key, flag in (("rtol", "--ray-rtol"), ("atol", "--ray-atol"),
                      ("max_steps", "--ray-max-steps")):
        if key in opts:
            common += [flag, str(opts[key])]
    ic = cfg["ic"]
    if fl["model"] == "rsw":
        return ["rsw", *common, "--cg", _num(fl["Cg"]), "--f-over-cg", _num(fl["f"] / fl["Cg"]),
                "--Kg", *map(_num, ic["Kg"]), "--Kw", *map(_num, ic["Kw"]),
                "--ag", _num(ic["ag"]), "--aw", _num(ic["aw"])]
    if fl["model"] == "twolayerqg":
        return ["twolayer", *common, "--cg", _num(fl["Cg"]), "--f", _num(fl["f"]),
                "--U", _num(fl["U"]), "--mu", _num(fl["mu"]),
                "--drho-rho0", _num(fl["drho_rho0"]), "--Kg", *map(_num, ic["Kg"]),
                "--ag", _num(ic["ag"])]
    raise ValueError(f"no command line for the flow model {fl['model']!r}")


def snapshot(x):
    """A copy of the driver's state that the program's later frames cannot
    touch."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(v) for v in x))
    if isinstance(x, tuple):
        return tuple(snapshot(v) for v in x)
    return x


def copy_into(dst, src):
    """``src`` copied into the tensors of ``dst`` (a ``snapshot`` of a state
    of the same shapes), so that taking it allocates nothing."""
    if isinstance(src, torch.Tensor):
        return dst.copy_(src)
    if isinstance(src, tuple) and hasattr(src, "_fields"):
        return type(src)(*(copy_into(d, v) for d, v in zip(dst, src)))
    if isinstance(src, tuple):
        return tuple(copy_into(d, v) for d, v in zip(dst, src))
    return src


class Program:
    """The driver of one configuration and traffic mix. ``log_fn`` takes
    the driver's log lines."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, log_fn=print):
        from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.args = cli.build_parser().parse_args(argv(cfg, traffic, seed, device))
        self.case = cli.SETUPS[self.args.cmd](self.args, log_fn)
        self.drv = cli.make_driver(self.args, self.case, log_fn=log_fn)
        opts = traffic.get("ray_opts") or {}
        extra = {k: v for k, v in opts.items() if k in ("init_substeps", "loop")}
        if extra:
            self.drv.ray_opts.update(extra)
        self.dt, self.nu = self.args.dt, self.case.model.params.nu
        self.infos: list = []

    def init(self, seed: int):
        """Start from the benchmark's inputs for ``seed`` -> (sol0, st0)."""
        sol0 = initial_flow(self.cfg, seed, self.device)
        st0 = packets(self.cfg, seed, self.device)
        pk = type(self.case.packets)(*(r.clone() for r in st0))
        # the birth/death key from ``seed``, as ``--seed`` gives it
        self.drv.bd_seed = seed
        self.drv.init(sol0, pk)
        self.infos = []
        return sol0, st0

    def spinup(self, steps: int):
        if steps:
            self.drv.spinup(steps)

    def frame(self, keep_infos: bool = True):
        """One frame of the traffic mix: ``run(1, steps)`` (coupled) or a
        flow-only ``spinup`` chunk; each ends in the driver's NaN guard.
        ``keep_infos``: keep the adaptive steps' infos in ``infos`` (they
        hold device tensors, so a window keeps only those it reads)."""
        steps = self.traffic["steps_per_frame"]
        if self.traffic["kind"] == "coupled":
            self.drv.run(1, steps)
            if keep_infos:
                self.infos.extend(self.drv.ray_infos)
        else:
            self.drv.spinup(steps, chunk=steps)

    @property
    def sim(self):
        return self.drv.sim

    def free(self):
        """Drop the driver and its state."""
        self.drv = self.case = None
