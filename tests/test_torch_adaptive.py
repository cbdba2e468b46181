"""Parity of the PyTorch port's adaptive ray path with the JAX package on
the CPU: the embedded tableaus, the per-stage patch sampler, the fused
DP5(4) attempt's twin and ``raytrace_adaptive``.

The reference has two attempt formulations, and each test compares like
with like. Its fused attempt (the Pallas kernel and its jnp twin) scales
the error by patch-local positions; its per-stage attempt scales it by
global positions. ``raytrace_adaptive`` uses the fused one only for the
patch gather with pair 'dopri5' and loop 'while'; the JAX package runs it
on the CPU only with ``JRSW_FUSED=jnp``, so the 'while' comparison sets
that variable, and the others use the JAX package's default.

Tolerances. Positions, wavenumbers and the clock agree to float32
round-off: rtol 1e-5 and, for components near zero, atol 5e-6, ten ulps
of the wavenumber's scale |k| = 5.2 (measured 1.7e-6). The error sum
``esum`` is h times a combination of O(1-10) stage slopes that cancels
down to the local truncation error, so its last digits are the round-off of that
cancellation: XLA and PyTorch order and contract the float32 sums
differently, and ``esum`` is compared at the size of that round-off. The
step size the controller picks from it, ``h_final``, agrees to rtol 1e-5
where the error estimate is well above its round-off floor: one attempt
over the whole interval at the hero's tolerances (rtol 1e-3, atol 1e-6),
as the hero's own intervals are (measured within 5e-6 for all three
configurations).
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    random_band_psih)
from juliaraytracingsw_tpu.ops import pallas_ray_step as jops  # noqa: E402
from juliaraytracingsw_tpu.rays import packets as jpk  # noqa: E402
from juliaraytracingsw_tpu.rays import patch as jpatch  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import ray_step as tops  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import patch as tpatch  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402

INTERPS = ["bilinear", "bspline", "bicubic"]
L = 2 * np.pi
HERO_TOLS = dict(rtol=1e-3, atol=1e-6)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rp(mod, nx, interp="bilinear", **kw):
    return mod.RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / nx, dy=L / nx,
                         interp=interp, **kw)


def _packets(n, seed=9):
    """Packets at random positions (off the grid's nodes) with |k| = 5.196."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-L / 2, L / 2, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    arrs = [a.astype(np.float32) for a in
            (x, y, 5.196 * np.cos(phase), 5.196 * np.sin(phase), sign)]
    return (jpk.Packets(*(jnp.asarray(a) for a in arrs)),
            tpk.Packets(*(torch.as_tensor(a) for a in arrs)))


def _flow_fields(nx=16, amp=0.5):
    """(old, new) bilinear field stacks of two band-limited random flows
    (|u| up to 1.7, |grad u| up to 6.3 at 16^2) as numpy."""
    g = jmake_grid(nx)
    return [np.array(jrt.fields_from_psih(
        random_band_psih(g, np.random.default_rng(seed), amp=amp), g))
        for seed in (2, 3)]


def _attempt_inputs(interp, n=256, nx=32, seed=5):
    """(rows_T, st) gathered from a pair table of random fields."""
    rng = np.random.default_rng(seed)
    nch = tops.n_channels(interp)
    fo, fn = (torch.as_tensor((rng.standard_normal((nch, nx, nx)) * 0.1)
                              .astype(np.float32)) for _ in range(2))
    rp = _rp(trt, nx, interp)
    T = trt.build_pair(fo, fn, rp)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    p = tpk.Packets(*(torch.as_tensor(a.astype(np.float32)) for a in
                      (x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign)))
    rows, bx, by = trt._gather_patch_rows(T, p, rp, nx, nx)
    return rows.t().contiguous(), torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by]), rp


def test_tableaus_pinned():
    for name in ("_DP_C", "_DP_A", "_DP_B", "_DP_B4", "_F78_C", "_F78_A",
                 "_F78_B7", "_F78_B8", "_EMBEDDED_PAIRS"):
        assert getattr(trt, name) == getattr(jrt, name), name


@pytest.mark.parametrize("interp", INTERPS)
def test_patch_interpolate_pair_shared_matches_jax(interp):
    """Random pair rows, offsets over the patch's valid window [-1, 2) and
    a little beyond (the clamped extension). Values are O(1)."""
    rng = np.random.default_rng(1)
    n = 300
    ph, pw, _ = tpatch.PATCH_SHAPES[interp]
    rows = rng.standard_normal((n, 2 * tops.n_channels(interp) * ph * pw)).astype(np.float32)
    lx, ly = rng.uniform(-1.5, 2.5, (2, n)).astype(np.float32)
    a = np.float32(0.3)
    ds = (0.2, 0.25)
    vt = tpatch.patch_interpolate_pair_shared(
        torch.as_tensor(rows), torch.as_tensor(lx), torch.as_tensor(ly),
        torch.tensor(a), method=interp, deriv_scale=ds)
    vj = jpatch.patch_interpolate_pair_shared(
        jnp.asarray(rows), jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(a),
        method=interp, deriv_scale=ds)
    assert vt.shape == (5, n)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), rtol=1e-5, atol=1e-6)


def _assert_attempts_match(out_t, out_j, rows_rtol=1e-6, rows_atol=1e-6):
    out_t, out_j = _np(out_t), np.asarray(out_j)
    np.testing.assert_allclose(out_t[:4], out_j[:4], rtol=rows_rtol, atol=rows_atol)
    # the error row: round-off of the b - b4 cancellation (see the module
    # docstring), bounded by 1% of its largest value (measured 0.3%)
    np.testing.assert_allclose(out_t[4], out_j[4], rtol=0,
                               atol=1e-2 * np.abs(out_j[4]).max())
    assert np.abs(out_j[4]).max() > 0


@pytest.mark.parametrize("interp", INTERPS)
def test_attempt_twin_matches_jax_twin(interp):
    """``attempt_torch`` against the JAX package's ``attempt_jnp``, eagerly
    (a jit of the unrolled bicubic graph compiles for minutes)."""
    rows_T, st, rp = _attempt_inputs(interp)
    scal = torch.tensor([0.25, 0.5, 0.01, 1e-3, 1e-6])
    cfg = tops.substep_cfg(rp, interp)
    out_t = tops.attempt_torch(rows_T, st, scal, cfg=cfg, interp=interp, x0=rp.x0,
                               y0=rp.y0)
    out_j = jops.attempt_jnp(jnp.asarray(_np(rows_T)), jnp.asarray(_np(st)),
                             jnp.asarray(_np(scal)), cfg=cfg, interp=interp,
                             x0=rp.x0, y0=rp.y0)
    assert out_t.shape == (5, st.shape[1]) and out_t.dtype == torch.float32
    _assert_attempts_match(out_t, out_j)
    assert float((out_t[:2] - st[:2]).abs().max()) > 1e-3      # packets moved


def test_attempt_twin_matches_jax_interpret_kernel():
    """The Pallas attempt kernel itself, run by the Pallas interpreter as
    the JAX package's own tests run it (bilinear, N = 64; rows to rtol
    1e-6, atol 1e-7 as there)."""
    rows_T, st, rp = _attempt_inputs("bilinear", n=64)
    scal = torch.tensor([0.0, 1.0, 0.01, 1e-5, 1e-7])
    out_t = tops.attempt_torch(rows_T, st, scal, cfg=tops.substep_cfg(rp, "bilinear"),
                               interp="bilinear", x0=rp.x0, y0=rp.y0)
    kern = jops.make_fused_attempt(_rp(jrt, 32), "bilinear", block=64,
                                   impl="interpret")
    out_j = kern(jnp.asarray(_np(rows_T)), jnp.asarray(_np(st)), jnp.asarray(_np(scal)))
    _assert_attempts_match(out_t, out_j, rows_atol=1e-7)


def test_fused_attempt_wrapper_on_cpu():
    """CPU tensors run the twin and count no launch; bad inputs raise."""
    rows_T, st, rp = _attempt_inputs("bspline", n=64)
    scal = torch.tensor([0.0, 1.0, 0.01, 1e-3, 1e-6])
    before = dict(tops.attempt_launches)
    out = tops.fused_attempt(rows_T, st, scal, rp=rp, interp="bspline")
    twin = tops.attempt_torch(rows_T, st, scal, cfg=tops.substep_cfg(rp, "bspline"),
                              interp="bspline", x0=rp.x0, y0=rp.y0)
    assert torch.equal(out, twin)
    assert tops.attempt_launches == before
    with pytest.raises(ValueError, match="shape"):
        tops.fused_attempt(rows_T, st, scal[:2], rp=rp, interp="bspline")
    with pytest.raises(TypeError, match="float32"):
        tops.fused_attempt(rows_T, st.double(), scal, rp=rp, interp="bspline")
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        tops.fused_attempt(rows_T.to("meta"), st.to("meta"), scal.to("meta"), rp=rp,
                           interp="bspline")


def _assert_packets_match(out_t, out_j, atol=5e-6):
    for name, a, b in zip(out_t._fields, out_t, out_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=atol, err_msg=name)


def _jax_adaptive(fused, calls):
    """The JAX package's raytrace_adaptive for each (args, kwargs) in
    ``calls``; ``fused`` runs its fused attempt through the jnp twin, as on
    the CPU only JRSW_FUSED=jnp does (all under one setting, so one compile)."""
    if not fused:
        return [jrt.raytrace_adaptive(*args, **kw) for args, kw in calls]
    os.environ["JRSW_FUSED"] = "jnp"
    try:
        jax.clear_caches()
        return [jax.block_until_ready(jrt.raytrace_adaptive(*args, **kw))
                for args, kw in calls]
    finally:
        del os.environ["JRSW_FUSED"]
        jax.clear_caches()


@pytest.mark.parametrize("pair,loop", [("dopri5", "while"), ("dopri5", "scan"),
                                       ("rkf78", "scan")])
def test_raytrace_adaptive_matches_jax(pair, loop):
    """16^2 flow, 1,024 packets; the 'while' case is the kernel's
    formulation. Two intervals:

    - 0.1 at the hero's tolerances: one attempt spans it (packets drift up
      to 0.4 cells); ``h_final`` to rtol 1e-5;
    - 0.2 at rtol 1e-4, atol 1e-7: DP5(4) rejects its first attempt. Here
      ``h_final`` is set by the last, shortened attempt, whose error
      estimate sits near its round-off floor, so it is bounded at 1%
      (measured 1.1e-4); the attempts after the first inherit that
      round-off in h, so the packets are bounded at 1e-5 of |k| = 5.2
      (measured 1.4e-5)."""
    fo, fn = _flow_fields()
    pj, pt = _packets(1024)
    cases = [(0.1, HERO_TOLS, 1e-5, 5e-6), (0.2, dict(rtol=1e-4, atol=1e-7), 1e-2, 5e-5)]
    kws = [dict(tols, max_steps=16, init_substeps=1, pair=pair, loop=loop)
           for _, tols, _, _ in cases]
    outs_j = _jax_adaptive(loop == "while", [
        ((pj, jnp.asarray(fo), jnp.asarray(fn), 0.0, t1, _rp(jrt, 16)), kw)
        for (t1, _, _, _), kw in zip(cases, kws)])
    for (t1, _, h_rtol, pk_atol), kw, (out_j, info_j) in zip(cases, kws, outs_j):
        out_t, info_t = trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn),
                                              0.0, t1, _rp(trt, 16), **kw)
        for key in ("n_accepted", "n_rejected"):
            assert int(info_t[key]) == int(info_j[key]), (t1, key)
        assert int(info_t["n_accepted"]) >= 1
        if pair == "dopri5" and t1 == 0.2:
            assert int(info_t["n_rejected"]) >= 1
        assert info_t["h_final"].dtype == torch.float32
        np.testing.assert_allclose(float(info_t["t_reached"]), float(info_j["t_reached"]),
                                   rtol=1e-5)
        assert float(info_t["t_reached"]) >= t1 * (1 - 1e-6)
        np.testing.assert_allclose(float(info_t["h_final"]), float(info_j["h_final"]),
                                   rtol=h_rtol)
        _assert_packets_match(out_t, out_j, atol=pk_atol)
        assert np.abs(_np(out_t.x) - _np(pt.x)).max() > 0.05


def test_raytrace_adaptive_taps_matches_jax():
    """The taps gather branch (global-gather sampler, per-stage attempt)."""
    fo, fn = _flow_fields()
    pj, pt = _packets(256)
    kw = dict(HERO_TOLS, max_steps=16, init_substeps=1)
    out_j, info_j = jrt.raytrace_adaptive(pj, jnp.asarray(fo), jnp.asarray(fn), 0.0, 0.1,
                                          _rp(jrt, 16, gather="taps"), **kw)
    out_t, info_t = trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn),
                                          0.0, 0.1, _rp(trt, 16, gather="taps"), **kw)
    for key in ("n_accepted", "n_rejected"):
        assert int(info_t[key]) == int(info_j[key]), key
    for key in ("t_reached", "h_final"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]), rtol=1e-5,
                                   err_msg=key)
    _assert_packets_match(out_t, out_j)


def test_raytrace_adaptive_while_reuses_rows_and_stops():
    """On the CPU the 'while' loop runs the fused attempt's twin; rejected
    attempts retry from the same positions, and the loop ends at t1."""
    fo, fn = _flow_fields()
    _, pt = _packets(64)
    rp = _rp(trt, 16)
    out, info = trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn), 0.0,
                                      0.2, rp, rtol=1e-4, atol=1e-7, max_steps=16,
                                      init_substeps=1, loop="while")
    assert int(info["n_rejected"]) >= 1
    assert float(info["t_reached"]) >= 0.2 * (1 - 1e-6)
    assert tops.attempt_launches == {k: 0 for k in tops.attempt_launches}
    with pytest.raises(ValueError, match="pair"):
        trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn), 0.0, 0.2, rp,
                              pair="vern7")
    with pytest.raises(ValueError, match="loop"):
        trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn), 0.0, 0.2, rp,
                              loop="until")


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_raytrace_adaptive_empty_interval_matches_jax(loop, monkeypatch):
    """t0 == t1: nothing moves and no attempt is counted, as in JAX; the
    'while' loop makes no attempt at all, since JAX's while_loop tests its
    condition before the first slot."""
    fo, fn = _flow_fields()
    pj, pt = _packets(64)
    kw = dict(HERO_TOLS, max_steps=4, init_substeps=1, loop=loop)
    if loop == "while":
        def no_attempt(*args, **kwargs):
            raise AssertionError("an attempt on an empty interval")
        monkeypatch.setattr(trt, "table_attempt", no_attempt)
    out_t, info_t = trt.raytrace_adaptive(pt, torch.as_tensor(fo), torch.as_tensor(fn), 0.1,
                                          0.1, _rp(trt, 16), **kw)
    out_j, info_j = jrt.raytrace_adaptive(pj, jnp.asarray(fo), jnp.asarray(fn), 0.1, 0.1,
                                          _rp(jrt, 16), **kw)
    for key in ("n_accepted", "n_rejected"):
        assert int(info_t[key]) == int(info_j[key]) == 0, key
    for key in ("t_reached", "h_final"):
        assert float(info_t[key]) == float(info_j[key]), key
    for a, b in zip(out_t, pt):
        assert torch.equal(a, b)
