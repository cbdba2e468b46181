"""The fused RK4 substep and DP5(4) attempt kernels on an NVIDIA GPU,
against their plain twins.

These tests need a CUDA device and ``nvcc``, and skip without one. They
import neither JAX nor its package, so they also run where JAX is absent,
without the suite's ``conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu_torch.ops import ray_step  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.patch import build_patch_table  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    RayParams, _gather_patch_rows, make_pair_table)

INTERPS = ["bilinear", "bspline", "bicubic"]
L = 2 * np.pi
NX = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(interp, device, n, seed=0, nx=NX):
    """Smooth fields (a few low modes) on an nx^2 grid, packets over three
    periods so base cells wrap, one substep of h = 2e-3."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(nx) * L / nx, np.arange(nx) * L / nx, indexing="ij")
    nch = ray_step.n_channels(interp)
    amp, kx, ky, ph = rng.uniform(0.1, 0.5, (4, 2, nch, 1, 1))
    fo, fn = (torch.as_tensor((a * np.sin(np.rint(4 * i) * xx + np.rint(4 * j) * yy + 6 * p))
                              .astype(np.float32), device=device)
              for a, i, j, p in zip(amp, kx, ky, ph))
    T_pair = make_pair_table(build_patch_table(fo, interp), build_patch_table(fn, interp))
    rp = RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / nx, dy=L / nx,
                   interp=interp)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    p = Packets(*(torch.as_tensor(a.astype(np.float32), device=device) for a in
                  (x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign)))
    rows, bx, by = _gather_patch_rows(T_pair, p, rp, nx, nx)
    st = torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by])
    scal = torch.tensor([0.25, 2e-3], device=device)
    return rows.t().contiguous(), st, scal, rp


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("interp", INTERPS)
def test_kernel_matches_twin(interp, n, cuda_device):
    """A ragged N (not a multiple of the 256-thread block) and N = 1."""
    rows_T, st, scal, rp = _inputs(interp, cuda_device, n)
    before = ray_step.launches[interp]
    out = ray_step.fused_substep(rows_T, st, scal, rp=rp, interp=interp, da=0.5)
    torch.cuda.synchronize()
    assert ray_step.launches[interp] == before + 1
    twin = ray_step.substep_torch(rows_T, st, scal, cfg=ray_step.substep_cfg(rp, interp),
                                  interp=interp, da=0.5, x0=rp.x0, y0=rp.y0)
    # the same formulas in the same order, up to FMA contraction
    torch.testing.assert_close(out, twin, rtol=1e-5, atol=1e-6)
    assert float((out[:2] - st[:2]).abs().max()) > 1e-4      # packets moved


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_do(cuda_device):
    rows_T, st, scal, rp = _inputs("bilinear", cuda_device, 64)
    call = dict(rp=rp, interp="bilinear", da=1.0)
    with pytest.raises(NotImplementedError, match="backward"):
        ray_step.fused_substep(rows_T.clone().requires_grad_(), st, scal, **call)
    with pytest.raises(ValueError, match="is on"):
        ray_step.fused_substep(rows_T, st.cpu(), scal, **call)
    before = dict(ray_step.launches)
    out = ray_step.fused_substep(rows_T.cpu(), st.cpu(), scal.cpu(), **call)
    assert out.device.type == "cpu" and ray_step.launches == before


def _attempt_scal(device):
    """[a0, dah, h, rtol, atol] at the adaptive hero's tolerances."""
    return torch.tensor([0.25, 0.5, 0.4, 1e-3, 1e-6], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("interp", INTERPS)
def test_attempt_kernel_matches_twin(interp, n, cuda_device):
    """One attempt of h = 0.4 on a 16^2 grid: the packets move about one
    cell and the error estimate lies far above its float32 round-off (batch
    norm 4e-3 to 0.3), so the error row is tested too."""
    rows_T, st, _, rp = _inputs(interp, cuda_device, n, nx=16)
    scal = _attempt_scal(cuda_device)
    before = ray_step.attempt_launches[interp]
    out = ray_step.fused_attempt(rows_T, st, scal, rp=rp, interp=interp)
    torch.cuda.synchronize()
    assert ray_step.attempt_launches[interp] == before + 1
    twin = ray_step.attempt_torch(rows_T, st, scal, cfg=ray_step.substep_cfg(rp, interp),
                                  interp=interp, x0=rp.x0, y0=rp.y0)
    # the same formulas in the same order, up to FMA contraction
    torch.testing.assert_close(out[:4], twin[:4], rtol=1e-5, atol=1e-6)
    # the error row esum cancels O(1-10) stage slopes down to the
    # truncation error: held to 2% of each packet's esum plus 2e-5 of the
    # largest, and the batch norm sqrt(sum / 4N) that the controller reads
    # to 5e-3 relative (the float32 twin against float64 on the CPU uses a
    # quarter of the first bound and reaches 5.1e-4 in the norm)
    esum_max = float(twin[4].max())
    assert esum_max > 0
    torch.testing.assert_close(out[4], twin[4], rtol=2e-2, atol=2e-5 * esum_max)
    norm_k, norm_t = (float(torch.sqrt(o[4].double().sum() / (4 * n))) for o in (out, twin))
    assert abs(norm_k - norm_t) <= 5e-3 * norm_t
    assert float((out[:2] - st[:2]).abs().max()) > 1e-1      # packets moved


@pytest.mark.cuda
def test_attempt_kernel_refuses_what_it_cannot_do(cuda_device):
    """Forward only; one device; CPU tensors run the twin and count nothing."""
    rows_T, st, _, rp = _inputs("bilinear", cuda_device, 64)
    scal = _attempt_scal(cuda_device)
    call = dict(rp=rp, interp="bilinear")
    with pytest.raises(NotImplementedError, match="backward"):
        ray_step.fused_attempt(rows_T, st.clone().requires_grad_(), scal, **call)
    with pytest.raises(ValueError, match="is on"):
        ray_step.fused_attempt(rows_T, st, scal.cpu(), **call)
    before = dict(ray_step.attempt_launches)
    out = ray_step.fused_attempt(rows_T.cpu(), st.cpu(), scal.cpu(), **call)
    assert out.device.type == "cpu" and ray_step.attempt_launches == before
