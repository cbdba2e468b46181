"""The plain reference the benchmark holds the port to.

Plain PyTorch, written from the equations the configurations state: the
doubly periodic spectral grid (``grid``), the f-plane rotating shallow
water and two-layer QG flows stepped by IF-AB3 with the exponential
tables worked out here (``flow``), and the WKB rays through interpolated,
table-rounded fields with RK4 or the adaptive DP5(4) (``rays``). It
imports nothing of the program and takes nothing the program made but the
state it is asked to follow (see ``portbench/check``).

What a configuration names is found by name (``find``): the interpolant
``cfg["rays"]["interp"]`` in ``interp/<name>.py``, each packet event of
``cfg["rays"]["events"]`` in ``events/<name>.py``. A part is added as a
file; nothing here names one.

Every function takes a ``Prec``: the reference runs at the precisions the
configuration states; the control (``Prec.lower``) rounds every float32
quantity to bfloat16 and the tables to float8 e4m3, the next precisions
below.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["Prec", "NOMINAL", "LOWER", "HERE", "find"]

HERE = Path(__file__).resolve().parent

_TABLE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}
# the precision one step below each stated one (the control's)
_BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back, complex parts each."""
    if dtype == torch.float32:
        return x
    if x.is_complex():
        r = torch.view_as_real(x)
        return torch.view_as_complex(r.to(dtype).to(r.dtype).contiguous())
    return x.to(dtype).to(x.dtype)


@dataclass(frozen=True)
class Prec:
    """``arith``: the precision of the flow's and the rays' arithmetic
    (float32 computed, rounded to it after every stage); ``table``: the
    storage of the ray tables."""

    arith: str = "float32"
    table: str = "bfloat16"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _round_to(x, _TABLE[self.arith])

    def t(self, x: torch.Tensor) -> torch.Tensor:
        return _round_to(x, _TABLE[self.table]).float()

    def lower(self) -> "Prec":
        return Prec(_BELOW[self.arith], _BELOW[self.table])


NOMINAL = Prec()
LOWER = NOMINAL.lower()


def find(kind: str, name: str, here: Path = HERE):
    """``<here>/<kind>/<name>.py`` as a module (``kind`` is ``interp`` or
    ``events``). A name with no file stops the run, saying so: nothing
    stands in for a part the configuration names."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: the configuration names the reference {kind} {name!r}, "
                         f"and {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"portbench_reference_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
