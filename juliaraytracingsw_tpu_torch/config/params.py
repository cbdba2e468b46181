"""Typed experiment configurations and sweep tables (the port's own copy of
``config/params.py``: dataclasses, no torch).

Dataclass configs with dotted-path overrides (``apply_overrides``) and a
loader for the reference's whitespace sweep tables (``load_sweep_table``:
a header of column names, then one row per array task), which the
``sweep`` subcommand runs. Field names mirror the reference's
Parameters.jl files, so configurations translate one to one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = [
    "DomainConfig", "StepperConfig", "OutputConfig", "PacketConfig",
    "ICConfig", "RSWRaytracingConfig", "QGRaytracingConfig",
    "load_sweep_table", "apply_overrides",
]


@dataclass
class DomainConfig:
    nx: int = 512
    L: float = 2.0 * np.pi
    aliased_fraction: float = 1.0 / 3.0


@dataclass
class StepperConfig:
    stepper: str = "IFMAB3"
    cfltune: float = 0.1       # dt = cfltune / umax * dx
    nutune: float = 1.0        # nu = nutune (2pi/nx) / kmax^{2 nnu} / dt
    nnu: int = 4
    use_filter: bool = False   # reference: use_filter = (nutune == 0)
    filter_order: float = 8.0
    T_dtype: str = "float32"


@dataclass
class OutputConfig:
    base_filename: str = "rsw"
    packet_base_filename: str = "packets"
    max_writes: int = 300
    packet_max_writes: int = 300
    output_dt: float = 10.0 / 3.0
    packet_output_dt: float = 1.0
    diag_dt: float = 0.5
    write_gradients: bool = True


@dataclass
class PacketConfig:
    sqrtNpackets: int = 128
    omega0_over_f: float = 2.0     # initial packet frequency / f
    packet_Cg: float = 1.0
    k_cutoff_over_Kd: float = 100.0  # k_cutoff = 100 f / Cg (reference)
    k_ring: bool = True            # ring of k-phases vs all (k0, 0)
    use_stationary_background_flow: bool = False
    packet_steps_per_flow_step: int = 1

    @property
    def Npackets(self) -> int:
        return self.sqrtNpackets**2

    def k0(self, f: float) -> float:
        """k0 = sqrt(omega0^2 - f^2)/Cg (raytracing/RaytracingDriver.jl:168)."""
        om0 = self.omega0_over_f * f
        return float(np.sqrt(om0**2 - f**2) / self.packet_Cg)

    def k_cutoff(self, f: float) -> float:
        return self.k_cutoff_over_Kd * f / self.packet_Cg


@dataclass
class ICConfig:
    kind: str = "band"     # band | front | file
    Kg: tuple = (10, 13)
    Kw: tuple = (0, 5)
    ag: float = 1.5
    aw: float = 0.1
    n_fronts: int = 10
    snapshot_file: str | None = None
    snapshot_key: str | None = None
    seed: int = 1234


@dataclass
class RSWRaytracingConfig:
    """Mirrors rsw/RSWRaytracingParameters.jl."""

    domain: DomainConfig = field(default_factory=DomainConfig)
    stepper: StepperConfig = field(default_factory=StepperConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    packets: PacketConfig = field(default_factory=PacketConfig)
    ic: ICConfig = field(default_factory=ICConfig)
    Cg: float = 1.0
    f_over_Cg: float = 3.0       # f = 3 Cg: fixed deformation radius
    spinup_T: float = 1000.0
    packet_spinup_T: float = 1000.0
    T: float = 2000.0

    @property
    def f(self) -> float:
        return self.f_over_Cg * self.Cg


@dataclass
class QGRaytracingConfig:
    """Mirrors swqg/RaytracingParameters.jl / TwoLayerRaytracingParameters.jl."""

    domain: DomainConfig = field(default_factory=DomainConfig)
    stepper: StepperConfig = field(default_factory=StepperConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    packets: PacketConfig = field(default_factory=PacketConfig)
    ic: ICConfig = field(default_factory=ICConfig)
    f: float = 3.0
    Cg: float = 1.0
    U: float = 0.5               # two-layer shear
    mu: float = 1e-2             # bottom drag
    drho_rho0: float = 0.2
    use_baroclinic_streamfunction: bool = True
    spinup_T: float = 100.0
    T: float = 1000.0


# --- sweep tables ------------------------------------------------------------

def load_sweep_table(path: str) -> list[dict[str, str]]:
    """Parse a reference-style whitespace sweep table: a header line of
    column names, then one row per array task (raytracing/parameters.txt,
    rsw/froude-parameters.txt)."""
    rows = []
    with open(path) as fh:
        header = None
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if header is None:
                header = parts
                continue
            rows.append(dict(zip(header, parts)))
    return rows


def apply_overrides(cfg, overrides: dict[str, Any]):
    """Apply dotted-path overrides: {'domain.nx': 1024, 'ic.ag': 2.0}.

    Values are coerced to the current field's type. Returns a new config
    (dataclasses.replace all the way down).
    """
    def set_path(obj, path, value):
        head, _, rest = path.partition(".")
        if rest:
            return dataclasses.replace(
                obj, **{head: set_path(getattr(obj, head), rest, value)}
            )
        current = getattr(obj, head)
        if current is not None and not isinstance(current, (tuple, list, str)) \
                and not isinstance(value, type(current)):
            value = type(current)(value)
        return dataclasses.replace(obj, **{head: value})

    for path, value in overrides.items():
        cfg = set_path(cfg, path, value)
    return cfg
