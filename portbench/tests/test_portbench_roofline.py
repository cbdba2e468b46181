"""The yardstick's arithmetic on fixed inputs."""
from __future__ import annotations

import math

import pytest
import torch

from portbench import roofline
from portbench.run import _held_rows


def test_held_rows_and_bytes_on_fixed_positions():
    cfg = {"nx": 4, "L": 4.0}
    # cells (ix, iy): (0, 0), (0, 0), (3, 1), (0, 0) after wrapping, (2, 3)
    st = torch.tensor([[-1.9, -1.5, 1.2, 2.1, 0.5],
                       [-1.9, -1.1, -0.7, -1.5, 1.9],
                       [0.0] * 5, [0.0] * 5, [1.0] * 5])
    assert _held_rows(st, cfg) == 3
    row = roofline.table_row_bytes("bilinear", "bfloat16")
    assert row == 2 * 4 * 4 * 5 * 2 == 320
    assert roofline.ray_step_bytes(3, 5, "bilinear", "bfloat16") == 3 * 320 + 9 * 4 * 5
    assert roofline.ray_attempt_bytes(3, 5, "bilinear", "bfloat16") == 3 * 320 + 10 * 4 * 5
    assert roofline.bound_s(3.35e12) == pytest.approx(1.0)


def test_the_hero_bound_is_chip_smokes():
    # 1M packets over a 512^2 grid hold every cell: 262,144 rows of 320 B
    # and the state: 0.0358 ms, the bound of the kernel table
    nbytes = roofline.ray_step_bytes(512 * 512, 1 << 20, "bilinear", "bfloat16")
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.0363, abs=6e-4)


def test_birth_death_and_flops():
    assert roofline.birth_death_bytes(10, 4) == 4 * (7 * 6 + 2 * 4 + 7 * 10) + 10
    assert roofline.fft_flops(512) == pytest.approx(2.5 * 512 ** 2 * 18)
    work = {"flow_transforms": 11, "field_transforms": 5, "block": 3}
    assert roofline.flow_step_flops(work, 512) > 11 * roofline.fft_flops(512)
    assert roofline.ray_flops_per_packet("adaptive") > roofline.ray_flops_per_packet("rk4")
    assert math.isfinite(roofline.fields_flops(work, 64))
