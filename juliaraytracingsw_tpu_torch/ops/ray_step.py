"""Fused ray kernels (port of ``ops/pallas_ray_step.py``).

Two hand-written CUDA kernels replace the reference's two Pallas TPU
kernels, each in two forms over one piece of stage math
(``csrc/ray_sample.cuh``), each beside its plain PyTorch twin, a
line-for-line copy of the reference's jnp twin:

- ``csrc/ray_step.cu`` (the reference's ``_kernel`` built by
  ``make_fused_substep``): one RK4 substep. ``table_substep`` launches its
  table form, the one the ray path runs; ``fused_substep`` its first cut.
  Twins: ``table_substep_torch``; ``substep_torch``
  (``_substep_math``/``substep_jnp``).
- ``csrc/ray_attempt.cu`` (``_attempt_kernel`` built by
  ``make_fused_attempt``): one embedded Dormand-Prince 5(4) attempt of the
  adaptive path. ``table_attempt`` launches its table form,
  ``fused_attempt`` its first cut. Twins: ``table_attempt_torch``;
  ``attempt_torch`` (``_attempt_math``/``attempt_jnp``).

A wrapper runs the twin for tensors on the CPU and the kernel for tensors
on the card; the tests marked ``cuda`` (``tests/test_torch_cuda.py``) hold
each kernel against its twin, and each table form against its first cut.

The first cut's contracts (the reference's): ``rows_T (2W, N)`` f32
gathered (old|new) patch rows, ``st (7, N)`` f32 = [x y k l sign bx by];
the substep takes ``scal (2,)`` = [a0, h] and gives ``(4, N)`` = [x' y' k'
l']; the attempt takes ``scal (5,)`` = [a0, dah, h, rtol, atol] and gives
``(5, N)`` = [x5 y5 k5 l5 esum], esum the packet's sum of squared scaled
errors.

The table forms take the pair table ``T_pair (ny*nx, 2W)`` as
``rays/raytrace.build_pair`` builds it (float32 or bfloat16) and
``st (5, N)`` f32 = [x y k l sign], find each packet's base cell and row
themselves, as ``rays/raytrace._gather_patch_rows`` does, and give the same
outputs. Their twins are that gather, the transpose and the first cut's
twin: the ray path's computation on the CPU.

The substep is differentiable, as the reference's ``make_fused_substep``
is through its custom VJP. ``table_substep`` and ``fused_substep`` run
through the ``torch.autograd.Function``s ``TableSubstep`` and
``FusedSubstep``: the forward is the kernel on the card and the twin on
the CPU; the backward, on both devices, recomputes the per-stage
formulation (``rays/raytrace._gather_patch_rows`` for the table form,
``_patch_sampler_from_rows`` and ``_step(..., "rk4")`` on ``(N, 2W)``
rows) under autograd and returns its VJP, so cotangents reach ``T_pair``
(through ``index_select``'s backward, in the table's own dtype),
``rows_T``, ``st`` and ``scal`` (``h``, and through it ``t0`` and ``t1``).
The backward is plain PyTorch and no hand-written kernel: the reference's
is plain XLA outside its Pallas kernel too. On the CPU the twins also take
float64 ``st`` and ``scal`` (the float64 gradient checks); the CUDA kernels
take float32 and raise for anything else. The attempt is forward only, as
in the reference: its wrappers raise when an input requires grad on the
card.
"""
from __future__ import annotations

import ctypes

import torch

from ..rays.patch import PATCH_SHAPES

__all__ = ["RK4_STAGES", "RK4_B", "FusedSubstep", "TableSubstep", "attempt_launches",
           "attempt_torch", "first_cut_inputs", "fused_attempt", "fused_substep",
           "launches", "n_channels", "recompute_vjp", "reset_launches", "substep_cfg",
           "substep_torch", "table_attempt", "table_attempt_launches",
           "table_attempt_torch", "table_launches", "table_substep", "table_substep_torch"]

RK4_STAGES = ((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)),
              (1.0, (0.0, 0.0, 1.0)))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)

_INTERP_ID = {"bilinear": 0, "bspline": 1, "bicubic": 2}
_TABLE_DTYPE_ID = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per interp, each counted by its wrapper where it launches
# its CUDA kernel and nowhere else (the CPU twin path does not count):
# fused_substep (launches), fused_attempt (attempt_launches), table_substep
# (table_launches), table_attempt (table_attempt_launches)
launches = {name: 0 for name in _INTERP_ID}
attempt_launches = {name: 0 for name in _INTERP_ID}
table_launches = {name: 0 for name in _INTERP_ID}
table_attempt_launches = {name: 0 for name in _INTERP_ID}


def reset_launches() -> None:
    for counts in (launches, attempt_launches, table_launches, table_attempt_launches):
        for name in counts:
            counts[name] = 0


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


def _attempt_math(read_tap, x, y, kk, ll, sgn, a0, dah, h, rtol, atol, cfg,
                  interp):
    """One embedded Dormand-Prince 5(4) attempt in patch-local coordinates:
    the 5th-order solution and the per-packet sum of squared scaled
    component errors, scaled by the patch-local positions."""
    from ..rays.raytrace import _DP_A, _DP_B, _DP_B4, _DP_C

    ph, pw, lo, W, dxg, dyg, f, Cg = cfg
    sample = _make_sample(read_tap, cfg, interp)

    def rhs(qx, qy, qk, ql, a):
        u, v, ux, uy, vx = sample(qx, qy, a)
        om = sgn * torch.sqrt(f * f + Cg * Cg * (qk * qk + ql * ql))
        cg = (Cg * Cg) / om
        return (u + cg * qk, v + cg * ql,
                -(ux * qk + vx * ql), -(uy * qk - ux * ql))

    ks = []
    for ci, aij in zip(_DP_C, _DP_A):
        qx, qy, qk, ql = x, y, kk, ll
        for kprev, aa in zip(ks, aij):
            if aa:
                qx = qx + h * aa * kprev[0]
                qy = qy + h * aa * kprev[1]
                qk = qk + h * aa * kprev[2]
                ql = ql + h * aa * kprev[3]
        ks.append(rhs(qx, qy, qk, ql, a0 + ci * dah))

    def lincomb(base, ws):
        acc = [None] * 4
        for kv, w in zip(ks, ws):
            if w == 0.0:
                continue
            for i in range(4):
                acc[i] = kv[i] * w if acc[i] is None else acc[i] + kv[i] * w
        return [b + h * a for b, a in zip(base, acc)]

    x5, y5, k5, l5 = lincomb((x, y, kk, ll), _DP_B)
    be = tuple(b - b4 for b, b4 in zip(_DP_B, _DP_B4))
    ex, ey, ek, el = lincomb((torch.zeros_like(x),) * 4, be)

    def comp(e, y_new, y_old):
        sc = atol + rtol * torch.maximum(torch.abs(y_old), torch.abs(y_new))
        r = e / sc
        return r * r

    esum = (comp(ex, x5, x) + comp(ey, y5, y)
            + comp(ek, k5, kk) + comp(el, l5, ll))
    return x5, y5, k5, l5, esum


def attempt_torch(rows_T, st, scal, *, cfg, interp, x0, y0):
    """Plain PyTorch twin of the attempt kernel: same formulas, same order.

    ``cfg = (ph, pw, lo, W, dx, dy, f, Cg)``."""
    x, y, kk, ll, sgn, bx, by = st.unbind(0)
    a0, dah, h, rtol, atol = scal.unbind(0)
    dxg, dyg = cfg[4], cfg[5]
    shx = x0 + bx * dxg
    shy = y0 + by * dyg

    def read_tap(t):
        return rows_T[t]

    x5, y5, k5, l5, esum = _attempt_math(
        read_tap, x - shx, y - shy, kk, ll, sgn, a0, dah, h, rtol, atol, cfg,
        interp)
    return torch.stack([x5 + shx, y5 + shy, k5, l5, esum])


def first_cut_inputs(T_pair, st, rp, ny: int, nx: int):
    """What the first cut takes for the packets of ``st (5, N)``, made as
    the ray path made it before the table kernels: the row gather and
    upcast, the transpose -> rows_T ``(2W, N)`` f32, and ``st (7, N)``."""
    from ..rays.packets import Packets
    from ..rays.raytrace import _gather_patch_rows

    rows, bx, by = _gather_patch_rows(T_pair, Packets(*st.unbind(0)), rp, ny, nx)
    return rows.t().contiguous(), torch.cat([st, torch.stack([bx, by])])


def table_substep_torch(T_pair, st, scal, *, rp, interp, da, ny, nx):
    """Plain PyTorch twin of the table substep kernel: the row gather, the
    transpose and ``substep_torch``."""
    rows_T, st7 = first_cut_inputs(T_pair, st, rp, ny, nx)
    return substep_torch(rows_T, st7, scal, cfg=substep_cfg(rp, interp), interp=interp,
                         da=da, x0=rp.x0, y0=rp.y0)


def table_attempt_torch(T_pair, st, scal, *, rp, interp, ny, nx):
    """Plain PyTorch twin of the table attempt kernel: the row gather, the
    transpose and ``attempt_torch``."""
    rows_T, st7 = first_cut_inputs(T_pair, st, rp, ny, nx)
    return attempt_torch(rows_T, st7, scal, cfg=substep_cfg(rp, interp), interp=interp,
                         x0=rp.x0, y0=rp.y0)


# --- the kernel wrappers -----------------------------------------------------

_F32 = (torch.float32,)
_REAL = (torch.float32, torch.float64)


def _kernel_fn(name: str, head: list, n_floats: int):
    """The C entry point ``name`` of the kernels' library: (``head``, st,
    scal, out, n, ``n_floats`` float constants, stream) -> cudaError_t."""
    from ._build import load_library

    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = (head + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def substep_cfg(rp, interp: str) -> tuple:
    """``(ph, pw, lo, W, dx, dy, f, Cg)`` of the twin for a RayParams."""
    ph, pw, lo = PATCH_SHAPES[interp]
    return (ph, pw, lo, n_channels(interp) * ph * pw, rp.dx, rp.dy, rp.f, rp.Cg)


def _pair_width(interp: str) -> int:
    if interp not in _INTERP_ID:
        raise ValueError(f"unsupported fused interp {interp!r}; "
                         f"available: {sorted(_INTERP_ID)}")
    ph, pw, _ = PATCH_SHAPES[interp]
    return 2 * n_channels(interp) * ph * pw


def _runs_on_cpu(specs, *, name: str, backward: bool = False) -> bool:
    """Validate a kernel's inputs, ``specs`` = (arg, tensor, shape, dtypes)
    with the device-setting tensor first: True when they lie on the CPU
    (the twin's case), False on the card (the kernel's case); raise
    otherwise. The CUDA kernels take no float64; a kernel without a
    ``backward`` refuses inputs that require grad on the card."""
    ref_arg, ref = specs[0][:2]
    for arg, t, shape, dtypes in specs:
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{arg} must be {names}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{arg} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
        if t.device != ref.device:
            raise ValueError(f"{arg} is on {t.device}, {ref_arg} on {ref.device}")
    if ref.device.type == "cpu":
        return True
    if ref.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CPU or CUDA tensors, not {ref.device.type}")
    for arg, t, _, _ in specs:
        if t.dtype == torch.float64:
            raise TypeError(f"the CUDA {name} takes float32 {arg}, got float64 "
                            "(float64 runs on the CPU twin only)")
    if not backward and any(t.requires_grad for _, t, _, _ in specs):
        raise NotImplementedError(
            f"the CUDA {name} has no backward: it is forward only, as in the "
            "reference")
    return False


def _fused_specs(rows_T, st, scal, interp: str, n_scal: int, real=_F32):
    n = st.shape[-1]
    return (("rows_T", rows_T, (_pair_width(interp), n), _F32),
            ("st", st, (7, n), real), ("scal", scal, (n_scal,), real))


def _table_specs(T_pair, st, scal, interp: str, n_scal: int, ny: int, nx: int, real=_F32):
    n = st.shape[-1]
    return (("T_pair", T_pair, (ny * nx, _pair_width(interp)), tuple(_TABLE_DTYPE_ID)),
            ("st", st, (5, n), real), ("scal", scal, (n_scal,), real))


def _launch(fn, args, st, scal, out, floats, stream=None) -> None:
    """Launch on ``stream`` (a ``cudaStream_t`` as an int), by default the
    current stream of ``st``'s device."""
    with torch.cuda.device(st.device):
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, st.data_ptr(), scal.data_ptr(), out.data_ptr(), st.shape[-1],
                 *map(ctypes.c_float, floats), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: cudaError_t {err}")


def _table_args(interp, T_pair, ny, nx) -> tuple:
    """(interp, dtype id, T_pair, ny, nx) of a table kernel. The kernel loads
    rows in 16-byte chunks: the table must start on a 16-byte boundary (every
    row width is a multiple of 16 bytes)."""
    if T_pair.data_ptr() % 16 or T_pair.shape[1] * T_pair.element_size() % 16:
        raise ValueError("T_pair's rows must start on 16-byte boundaries for the "
                         "kernel's 16-byte loads")
    return (_INTERP_ID[interp], _TABLE_DTYPE_ID[T_pair.dtype], T_pair.data_ptr(), ny, nx)


_FUSED_HEAD = [ctypes.c_int, ctypes.c_void_p]
_TABLE_HEAD = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]


def _substep_floats(rp, da) -> tuple:
    return (rp.x0, rp.y0, rp.dx, rp.dy, rp.f * rp.f, rp.Cg * rp.Cg, 0.5 * da, 1.0 * da,
            RK4_B[0], RK4_B[1])


def _attempt_floats(rp) -> tuple:
    return (rp.x0, rp.y0, rp.dx, rp.dy, rp.f * rp.f, rp.Cg * rp.Cg)


# --- the substep's backward: the per-stage formulation under autograd ----------

def _per_stage_substep(rows, p, bx, by, scal, rp, da):
    """The reference's backward formulation of one RK4 substep: the
    per-stage sampler over ``(N, 2W)`` rows and ``_step(..., "rk4")`` ->
    ``(4, N)``."""
    from ..rays.raytrace import _patch_sampler_from_rows, _step

    out = _step(p, _patch_sampler_from_rows(rows, bx, by, rp), scal[0], da, scal[1], rp,
                "rk4")
    return torch.stack([out.x, out.y, out.k, out.l])


def recompute_vjp(saved, needs, g, formulation):
    """The backward of an ``autograd.Function`` by recomputation: the
    cotangents (None where ``needs`` is False) of the ``saved`` inputs from
    ``formulation`` of fresh leaves of them, recomputed under autograd, and
    its VJP at the output cotangent(s) ``g``."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(())
    if wanted:
        with torch.enable_grad():
            out = formulation(*leaves)
            grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in leaves]


class TableSubstep(torch.autograd.Function):
    """``table_substep`` with the reference's backward:
    ``(T_pair, st (5, N), scal (2,)) -> (4, N)``. Forward: the table kernel
    on the card (one table launch), its twin on the CPU. Backward: the row
    gather, the per-stage sampler and ``_step(..., "rk4")`` recomputed and
    differentiated (``T_pair``'s cotangent through ``index_select``'s
    backward, accumulated in the table's dtype)."""

    @staticmethod
    def forward(ctx, T_pair, st, scal, rp, interp, da, ny, nx, on_cpu):
        ctx.save_for_backward(T_pair, st, scal)
        ctx.cfg = (rp._replace(interp=interp), da, ny, nx)
        if on_cpu:
            return table_substep_torch(T_pair, st, scal, rp=rp, interp=interp, da=da, ny=ny,
                                       nx=nx)
        out = torch.empty((4, st.shape[-1]), dtype=torch.float32, device=st.device)
        _launch(_kernel_fn("jrsw_ray_step_table", _TABLE_HEAD, 10),
                _table_args(interp, T_pair, ny, nx), st, scal, out, _substep_floats(rp, da))
        table_launches[interp] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        from ..rays.packets import Packets
        from ..rays.raytrace import _gather_patch_rows

        rp, da, ny, nx = ctx.cfg

        def formulation(T_pair, st, scal):
            p = Packets(*st.unbind(0))
            rows, bx, by = _gather_patch_rows(T_pair, p, rp, ny, nx)
            return _per_stage_substep(rows, p, bx, by, scal, rp, da)

        return (*recompute_vjp(ctx.saved_tensors, ctx.needs_input_grad, g, formulation),
                None, None, None, None, None, None)


class FusedSubstep(torch.autograd.Function):
    """``fused_substep`` with the reference's backward (its custom VJP,
    ``ops/pallas_ray_step.make_fused_substep``):
    ``(rows_T (2W, N), st (7, N), scal (2,)) -> (4, N)``. Forward: the
    first-cut kernel on the card (one launch), its twin on the CPU.
    Backward: the per-stage formulation on ``rows_T.T``, differentiated."""

    @staticmethod
    def forward(ctx, rows_T, st, scal, rp, interp, da, on_cpu):
        ctx.save_for_backward(rows_T, st, scal)
        ctx.cfg = (rp._replace(interp=interp), da)
        if on_cpu:
            return substep_torch(rows_T, st, scal, cfg=substep_cfg(rp, interp),
                                 interp=interp, da=da, x0=rp.x0, y0=rp.y0)
        out = torch.empty((4, st.shape[-1]), dtype=torch.float32, device=st.device)
        _launch(_kernel_fn("jrsw_ray_step", _FUSED_HEAD, 10),
                (_INTERP_ID[interp], rows_T.data_ptr()), st, scal, out, _substep_floats(rp, da))
        launches[interp] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        from ..rays.packets import Packets

        rp, da = ctx.cfg

        def formulation(rows_T, st, scal):
            x, y, kk, ll, sgn, bx, by = st.unbind(0)
            return _per_stage_substep(rows_T.t(), Packets(x, y, kk, ll, sgn), bx, by, scal,
                                      rp, da)

        return (*recompute_vjp(ctx.saved_tensors, ctx.needs_input_grad, g, formulation),
                None, None, None, None)


def fused_substep(rows_T: torch.Tensor, st: torch.Tensor, scal: torch.Tensor, *,
                  rp, interp: str, da: float) -> torch.Tensor:
    """One fused RK4 substep, the first cut: ``(2W, N), (7, N), (2,) -> (4, N)``.

    CUDA tensors go through the hand-written kernel (and count one launch);
    CPU tensors go through the plain twin (float32 or float64 ``st`` and
    ``scal``). Differentiable (``FusedSubstep``). Anything else raises."""
    on_cpu = _runs_on_cpu(_fused_specs(rows_T, st, scal, interp, 2, _REAL),
                          name="fused substep", backward=True)
    return FusedSubstep.apply(rows_T, st, scal, rp, interp, da, on_cpu)


def fused_attempt(rows_T: torch.Tensor, st: torch.Tensor, scal: torch.Tensor, *,
                  rp, interp: str) -> torch.Tensor:
    """One fused embedded DP5(4) attempt, the first cut:
    ``(2W, N), (7, N), (5,) -> (5, N)``.

    Forward only. CUDA tensors go through the hand-written kernel (and
    count one attempt launch); CPU tensors go through the plain twin.
    Anything else raises."""
    if _runs_on_cpu(_fused_specs(rows_T, st, scal, interp, 5), name="fused attempt"):
        return attempt_torch(rows_T, st, scal, cfg=substep_cfg(rp, interp),
                             interp=interp, x0=rp.x0, y0=rp.y0)
    out = torch.empty((5, st.shape[-1]), dtype=torch.float32, device=st.device)
    _launch(_kernel_fn("jrsw_ray_attempt", _FUSED_HEAD, 6),
            (_INTERP_ID[interp], rows_T.data_ptr()), st, scal, out, _attempt_floats(rp))
    attempt_launches[interp] += 1
    return out


def table_substep(T_pair: torch.Tensor, st: torch.Tensor, scal: torch.Tensor, *,
                  rp, interp: str, da: float, ny: int, nx: int) -> torch.Tensor:
    """One fused RK4 substep reading the pair table itself:
    ``(ny*nx, 2W) f32|bf16, (5, N), (2,) -> (4, N)``.

    CUDA tensors go through the hand-written kernel (and count one table
    launch); CPU tensors go through the plain twin (float32 or float64
    ``st`` and ``scal``). Differentiable (``TableSubstep``). Anything else
    raises."""
    on_cpu = _runs_on_cpu(_table_specs(T_pair, st, scal, interp, 2, ny, nx, _REAL),
                          name="table substep", backward=True)
    return TableSubstep.apply(T_pair, st, scal, rp, interp, da, ny, nx, on_cpu)


def table_attempt(T_pair: torch.Tensor, st: torch.Tensor, scal: torch.Tensor, *,
                  rp, interp: str, ny: int, nx: int, out: torch.Tensor | None = None,
                  stream: int | None = None) -> torch.Tensor:
    """One fused embedded DP5(4) attempt reading the pair table itself:
    ``(ny*nx, 2W) f32|bf16, (5, N), (5,) -> (5, N)``.

    Forward only. CUDA tensors go through the hand-written kernel (and
    count one table attempt launch); CPU tensors go through the plain twin.
    Anything else raises. On the card the kernel writes ``out`` (5, N)
    float32 where it is given and launches on ``stream`` (a ``cudaStream_t``
    as an int) where it is given: the adaptive loop's slot on the device
    (``ops/adaptive_loop``) allocates nothing and may launch into the body
    of a CUDA graph's WHILE node."""
    specs = _table_specs(T_pair, st, scal, interp, 5, ny, nx)
    if out is not None:
        specs += (("out", out, (5, st.shape[-1]), _F32),)
    if _runs_on_cpu(specs, name="table attempt"):
        if out is not None:
            raise ValueError("out= is for the CUDA kernel; the twin returns a new tensor")
        return table_attempt_torch(T_pair, st, scal, rp=rp, interp=interp, ny=ny, nx=nx)
    if out is None:
        out = torch.empty((5, st.shape[-1]), dtype=torch.float32, device=st.device)
    _launch(_kernel_fn("jrsw_ray_attempt_table", _TABLE_HEAD, 6),
            _table_args(interp, T_pair, ny, nx), st, scal, out, _attempt_floats(rp), stream)
    table_attempt_launches[interp] += 1
    return out
