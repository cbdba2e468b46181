"""Fused RK4 ray substep over gathered patch rows (port of
``ops/pallas_ray_step.py``).

``fused_substep`` is the wrapper of the hand-written CUDA kernel
``csrc/ray_step.cu``, which replaces the reference's Pallas TPU kernel
(``_kernel`` built by ``make_fused_substep``). ``substep_torch`` is its
plain PyTorch twin, a line-for-line copy of the reference's
``_substep_math``/``substep_jnp``: the wrapper runs it for tensors on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it.

Contract (the reference's): ``rows_T (2W, N)`` f32 gathered (old|new) patch
rows, ``st (7, N)`` f32 = [x y k l sign bx by], ``scal (2,)`` f32 = [a0, h]
-> ``(4, N)`` f32 = [x' y' k' l'].
"""
from __future__ import annotations

import ctypes

import torch

from ..rays.patch import PATCH_SHAPES

__all__ = ["RK4_STAGES", "RK4_B", "fused_substep", "launches", "n_channels",
           "reset_launches", "substep_torch"]

RK4_STAGES = ((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)),
              (1.0, (0.0, 0.0, 1.0)))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)

_INTERP_ID = {"bilinear": 0, "bspline": 1, "bicubic": 2}

# kernel launches per interp, counted by fused_substep where it launches
# the CUDA kernel and nowhere else (the CPU twin path does not count)
launches = {name: 0 for name in _INTERP_ID}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def n_channels(interp: str) -> int:
    """Field channels in a patch-table row: 5 base fields, x4 for the
    bicubic [f|fx|fy|fxy] corner-data layout."""
    return 20 if interp == "bicubic" else 5


# --- the plain twin ----------------------------------------------------------

def _axis_weights_hermite(local, size, lo, scale):
    """Hermite cubic per-axis weights: value basis (h00, h01) and derivative
    basis (h10, h11) scaled by the cell size, as ``size`` tensors each."""
    j0 = torch.clip(torch.floor(local), -float(lo), float(size - lo - 2))
    a = local - j0
    a2, a3 = a * a, a * a * a
    h00, h01 = 1.0 - 3.0 * a2 + 2.0 * a3, 3.0 * a2 - 2.0 * a3
    h10, h11 = (a - 2.0 * a2 + a3) * scale, (a3 - a2) * scale
    t = j0 + lo
    zero = torch.zeros_like(a)
    wv, wd = [], []
    for j in range(size):
        v = torch.where(t == float(j), h00, zero)
        d = torch.where(t == float(j), h10, zero)
        if j >= 1:
            v = v + torch.where(t == float(j - 1), h01, zero)
            d = d + torch.where(t == float(j - 1), h11, zero)
        wv.append(v)
        wd.append(d)
    return wv, wd


def _axis_weights(local, size, lo, interp):
    """Per-axis tap weights as a list of ``size`` tensors."""
    zero = torch.zeros_like(local)
    if interp == "bilinear":
        j0 = torch.clip(torch.floor(local), -float(lo), float(size - lo - 2))
        a = local - j0
        taps = j0 + lo
        ws = []
        for j in range(size):
            w = torch.where(taps == float(j), 1.0 - a, zero)
            if j >= 1:
                w = w + torch.where(taps == float(j - 1), a, zero)
            ws.append(w)
        return ws
    if interp == "bspline":
        j0 = torch.clip(torch.floor(local), -float(lo - 1), float(size - lo - 3))
        a = local - j0
        a2, a3 = a * a, a * a * a
        w4 = ((1.0 - 3.0 * a + 3.0 * a2 - a3) / 6.0,
              (4.0 - 6.0 * a2 + 3.0 * a3) / 6.0,
              (1.0 + 3.0 * a + 3.0 * a2 - 3.0 * a3) / 6.0,
              a3 / 6.0)
        base = j0 + (lo - 1)
        ws = []
        for j in range(size):
            w = None
            for s in range(4):
                if 0 <= j - s <= size - 4:
                    term = torch.where(base == float(j - s), w4[s], zero)
                    w = term if w is None else w + term
            ws.append(w if w is not None else zero)
        return ws
    raise ValueError(f"unsupported fused interp {interp!r}")


def _make_sample(read_tap, cfg, interp):
    """``sample(qx, qy, a) -> 5 field values`` over the pre-gathered pair
    taps ``read_tap(t)``."""
    ph, pw, lo, W, dxg, dyg, f, Cg = cfg
    npp = ph * pw

    if interp == "bicubic":
        def sample(qx, qy, a):
            wxv, wxd = _axis_weights_hermite(qx / dxg, pw, lo, dxg)
            wyv, wyd = _axis_weights_hermite(qy / dyg, ph, lo, dyg)
            blocks = ((wyv, wxv), (wyv, wxd), (wyd, wxv), (wyd, wxd))
            w_b = [[wy[jy] * wx[jx] for jy in range(ph) for jx in range(pw)]
                   for wy, wx in blocks]
            vals = []
            for c in range(5):
                vo = None
                vn = None
                for b in range(4):
                    for t in range(npp):
                        idx = (b * 5 + c) * npp + t
                        ro = read_tap(idx) * w_b[b][t]
                        rn = read_tap(W + idx) * w_b[b][t]
                        vo = ro if vo is None else vo + ro
                        vn = rn if vn is None else vn + rn
                vals.append((1.0 - a) * vo + a * vn)
            return vals

        return sample

    def sample(qx, qy, a):
        wx = _axis_weights(qx / dxg, pw, lo, interp)
        wy = _axis_weights(qy / dyg, ph, lo, interp)
        w = [wy[jy] * wx[jx] for jy in range(ph) for jx in range(pw)]
        vals = []
        for c in range(5):
            vo = None
            vn = None
            for t in range(npp):
                idx = c * npp + t
                ro = read_tap(idx) * w[t]
                rn = read_tap(W + idx) * w[t]
                vo = ro if vo is None else vo + ro
                vn = rn if vn is None else vn + rn
            vals.append((1.0 - a) * vo + a * vn)
        return vals

    return sample


def _substep_math(read_tap, x, y, kk, ll, sgn, a0, da, h, cfg, interp):
    """One RK4 substep in patch-local coordinates (positions pre-shifted to
    the patch base, so local offsets are q/d)."""
    ph, pw, lo, W, dxg, dyg, f, Cg = cfg
    sample = _make_sample(read_tap, cfg, interp)

    def rhs(qx, qy, qk, ql, a):
        u, v, ux, uy, vx = sample(qx, qy, a)
        om = sgn * torch.sqrt(f * f + Cg * Cg * (qk * qk + ql * ql))
        cg = (Cg * Cg) / om
        return (u + cg * qk, v + cg * ql,
                -(ux * qk + vx * ql), -(uy * qk - ux * ql))

    ks = []
    for ci, aij in RK4_STAGES:
        qx, qy, qk, ql = x, y, kk, ll
        for kprev, aa in zip(ks, aij):
            if aa:
                qx = qx + h * aa * kprev[0]
                qy = qy + h * aa * kprev[1]
                qk = qk + h * aa * kprev[2]
                ql = ql + h * aa * kprev[3]
        ks.append(rhs(qx, qy, qk, ql, a0 + ci * da))
    dx = dy = dk = dl = None
    for kv, b in zip(ks, RK4_B):
        dx = kv[0] * b if dx is None else dx + kv[0] * b
        dy = kv[1] * b if dy is None else dy + kv[1] * b
        dk = kv[2] * b if dk is None else dk + kv[2] * b
        dl = kv[3] * b if dl is None else dl + kv[3] * b
    return x + h * dx, y + h * dy, kk + h * dk, ll + h * dl


def substep_torch(rows_T, st, scal, *, cfg, interp, da, x0, y0):
    """Plain PyTorch twin of the kernel: same formulas, same order.

    ``cfg = (ph, pw, lo, W, dx, dy, f, Cg)``."""
    ph, pw, lo, W, dxg, dyg, f, Cg = cfg
    x, y, kk, ll, sgn, bx, by = st.unbind(0)
    a0, h = scal[0], scal[1]
    shx = x0 + bx * dxg
    shy = y0 + by * dyg

    def read_tap(t):
        return rows_T[t]

    nx_, ny_, nk_, nl_ = _substep_math(
        read_tap, x - shx, y - shy, kk, ll, sgn, a0, da, h, cfg, interp)
    return torch.stack([nx_ + shx, ny_ + shy, nk_, nl_])


# --- the kernel wrapper ------------------------------------------------------

def _kernel_fn():
    from ._build import load_library

    fn = load_library().jrsw_ray_step
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def substep_cfg(rp, interp: str) -> tuple:
    """``(ph, pw, lo, W, dx, dy, f, Cg)`` of the twin for a RayParams."""
    ph, pw, lo = PATCH_SHAPES[interp]
    return (ph, pw, lo, n_channels(interp) * ph * pw, rp.dx, rp.dy, rp.f, rp.Cg)


def fused_substep(rows_T: torch.Tensor, st: torch.Tensor, scal: torch.Tensor, *,
                  rp, interp: str, da: float) -> torch.Tensor:
    """One fused RK4 substep: ``(2W, N), (7, N), (2,) -> (4, N)``.

    CUDA tensors go through the hand-written kernel (and count one launch);
    CPU tensors go through the plain twin. Anything else raises."""
    if interp not in _INTERP_ID:
        raise ValueError(f"unsupported fused interp {interp!r}; "
                         f"available: {sorted(_INTERP_ID)}")
    cfg = substep_cfg(rp, interp)
    W = cfg[3]
    n = st.shape[-1]
    for name, t, shape in (("rows_T", rows_T, (2 * W, n)), ("st", st, (7, n)),
                           ("scal", scal, (2,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != rows_T.device:
            raise ValueError(f"{name} is on {t.device}, rows_T on {rows_T.device}")

    if rows_T.device.type == "cpu":
        return substep_torch(rows_T, st, scal, cfg=cfg, interp=interp, da=da,
                             x0=rp.x0, y0=rp.y0)
    if rows_T.device.type != "cuda":
        raise RuntimeError(f"fused_substep runs on CPU or CUDA tensors, "
                           f"not {rows_T.device.type}")
    if rows_T.requires_grad or st.requires_grad or scal.requires_grad:
        raise NotImplementedError(
            "the CUDA fused substep has no backward yet (ROADMAP queue 1, "
            "item 14: autograd.Function around the kernel)")

    out = torch.empty((4, n), dtype=torch.float32, device=rows_T.device)
    f32 = ctypes.c_float
    with torch.cuda.device(rows_T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(
            _INTERP_ID[interp], rows_T.data_ptr(), st.data_ptr(), scal.data_ptr(),
            out.data_ptr(), n, f32(rp.x0), f32(rp.y0), f32(rp.dx), f32(rp.dy),
            f32(rp.f * rp.f), f32(rp.Cg * rp.Cg), f32(0.5 * da), f32(1.0 * da),
            f32(RK4_B[0]), f32(RK4_B[1]), stream)
    if err != 0:
        raise RuntimeError(f"ray_step kernel launch failed: cudaError_t {err}")
    launches[interp] += 1
    return out
