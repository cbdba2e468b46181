"""Weibull birth/death of the packet ensemble: one CUDA kernel and its twin.

``birth_death`` is the whole of the reference's
``rays/resample.weibull_birth_death`` for one flow step, on the packets'
and the ensemble's tensors: on CUDA tensors it launches
``csrc/birth_death.cu`` (one thread a packet, the Threefry draws inlined,
one atomic a block for the birth count) and counts one launch; on CPU
tensors it runs ``birth_death_torch``, the plain version built on
``rays/prng``; anything else raises. Both go through ``BirthDeath``, whose
backward is the plain version's: gradients reach a live packet's inputs
and ``dt``, none a dead one's. The reference has no Pallas kernel
here (XLA fuses the function); the kernel exists because the twin is some
700 small launches a flow step on the card.

Both compute, for packet i with age a, lifetime L and the parent key K:

- ``K', kx, ky, kl, ks = split(K, 5)``; the draws of packet i are the
  uniforms of those subkeys at counter i (``rays/prng.uniform``);
- ``dead = a + dt >= L``; a dead packet moves to ``(x0 + ux Lx, y0 + uy
  Ly)`` (one rounding in float32, as the reference's fused multiply-add),
  takes ``(k0, 0)``, branch ``+1`` if ``us < 0.5`` else ``-1``, age 0 and
  lifetime ``lam (-log ul)^(1/k_shape)`` with ``ul`` uniform in [1e-12, 1);
  a live one keeps everything and ages to ``a + dt``;
- ``births + sum(dead)`` in int32.

``(-log u)^(1/k_shape)`` is evaluated in float64 and rounded once to the
dtype: the CPU's and the card's float32 ``log`` and ``pow`` differ by an
ulp, their float64 ones almost never after the rounding to float32, so in
float32 the twin on either device and the kernel agree bit for bit (in
float64 the two devices' libm leave a few ulps); against the reference's
float32 ``log`` and ``pow`` a lifetime differs by an ulp or two.

Keys are ``(2,)`` uint32 tensors, ``births`` a 0-d int32 tensor; the
packet and age/lifetime tensors share one dtype (float32 or float64) on
the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..rays.prng import fma_rounded, split, uniform

__all__ = ["birth_death", "birth_death_torch", "BirthDeath", "weibull", "launches",
           "reset_launches"]

# the lifetime draw's minval (the reference's _weibull)
LIFE_MIN = 1e-12
_DTYPE_ID = {torch.float32: 0, torch.float64: 1}

# launches of the CUDA kernel, counted by ``birth_death`` where it launches
# it and nowhere else
launches = {"birth_death": 0}


def reset_launches() -> None:
    launches["birth_death"] = 0


def weibull(key: torch.Tensor, n: int, k_shape: float, lam: float,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``n`` Weibull(k_shape, lam) lifetimes from ``key`` (the reference's
    ``_weibull``): ``lam (-log u)^(1/k_shape)``, u uniform in [1e-12, 1)."""
    u = uniform(key, n, dtype, LIFE_MIN, 1.0)
    core = (-torch.log(u.double())) ** (1.0 / k_shape)
    return core.to(dtype) * lam


def birth_death_torch(x, y, k, l, sign, age, lifetime, key, births, dt, *, Lx: float,
                      Ly: float, k0: float, k_shape: float, lam: float, x0: float,
                      y0: float):
    """The plain version: ``(x, y, k, l, sign, age, lifetime, key, births,
    dead)`` after one step of ``dt``."""
    n = x.shape[0]
    age = age + dt
    dead = age >= lifetime
    new_key, kx, ky, kl, ks = split(key, 5)
    new_x = fma_rounded(uniform(kx, n, x.dtype), Lx, x0)
    new_y = fma_rounded(uniform(ky, n, y.dtype), Ly, y0)
    new_life = weibull(kl, n, k_shape, lam, lifetime.dtype)
    new_sign = torch.where(uniform(ks, n, lifetime.dtype) < 0.5, 1.0, -1.0).to(sign.dtype)
    return (torch.where(dead, new_x, x), torch.where(dead, new_y, y),
            torch.where(dead, torch.full_like(k, k0), k),
            torch.where(dead, torch.zeros_like(l), l),
            torch.where(dead, new_sign, sign),
            torch.where(dead, torch.zeros_like(age), age),
            torch.where(dead, new_life, lifetime),
            new_key, births + dead.sum().to(torch.int32), dead)


def _check(tensors: dict, key, births, n: int) -> torch.dtype:
    dtype = tensors["x"].dtype
    device = tensors["x"].device
    if dtype not in _DTYPE_ID:
        raise TypeError(f"the CUDA birth/death kernel takes float32 or float64, got {dtype}")
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {dtype}: the kernel takes one dtype")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    if key.dtype != torch.uint32 or tuple(key.shape) != (2,) or key.device != device:
        raise ValueError(f"key must be a (2,) uint32 tensor on {device}")
    if births.dtype != torch.int32 or births.shape != () or births.device != device:
        raise ValueError(f"births must be a 0-d int32 tensor on {device}")
    if n >= 1 << 32:
        raise ValueError("the draws' counters are 32-bit: at most 2^32 - 1 packets")
    return dtype


def _launch(ins: dict, key, births, dt, consts: dict):
    """The kernel on CUDA tensors: ``(x, y, k, l, sign, age, lifetime, key,
    births, dead)``, one launch counted."""
    x = ins["x"]
    n = x.shape[0]
    dtype = _check(ins, key, births, n)
    outs = [torch.empty_like(t) for t in ins.values()]
    dead = torch.empty(n, dtype=torch.bool, device=x.device)
    key_out = torch.empty(2, dtype=torch.uint32, device=x.device)
    births_out = births.clone()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    life_lo, one = np_dtype(LIFE_MIN), np_dtype(1.0)
    c = consts
    scalars = (ctypes.c_double * 9)(c["Lx"], c["Ly"], c["x0"], c["y0"], c["k0"], c["lam"],
                                    float(one - life_lo), float(life_lo), 1.0 / c["k_shape"])
    ptrs_in = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in ins.values()))
    ptrs_out = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in outs))
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPE_ID[dtype], ptrs_in, dt.data_ptr(), key.data_ptr(), ptrs_out,
                 dead.data_ptr(), key_out.data_ptr(), births_out.data_ptr(), n, scalars,
                 stream)
    if err != 0:
        raise RuntimeError(f"birth/death kernel launch failed: cudaError_t {err}")
    launches["birth_death"] += 1
    return (*outs, key_out, births_out, dead)


class BirthDeath(torch.autograd.Function):
    """``birth_death`` with the plain version's gradient. Forward: the
    kernel on the card, the twin on the CPU. Backward: a live packet's
    cotangents pass through (its age's also to ``dt``); a dead one's are 0,
    its new values being draws and constants."""

    @staticmethod
    def forward(ctx, x, y, k, l, sign, age, lifetime, dt, key, births, consts):
        ctx.dt_meta = (dt.shape, dt.dtype, dt.device)
        if x.device.type == "cpu":
            out = birth_death_torch(x, y, k, l, sign, age, lifetime, key, births, dt, **consts)
        else:
            dt = dt.to(device=x.device, dtype=x.dtype).reshape(()).contiguous()
            out = _launch(dict(x=x, y=y, k=k, l=l, sign=sign, age=age, lifetime=lifetime),
                          key, births, dt, consts)
        ctx.mark_non_differentiable(*out[7:])
        ctx.save_for_backward(out[9])
        return out

    @staticmethod
    def backward(ctx, *grads):
        (dead,) = ctx.saved_tensors
        need = list(ctx.needs_input_grad)
        live = [torch.where(dead, torch.zeros_like(g), g) if want or (i == 5 and need[7])
                else None for i, (g, want) in enumerate(zip(grads[:7], need))]
        g_dt = None
        if need[7]:
            shape, dtype, device = ctx.dt_meta
            g_dt = live[5].sum_to_size(shape).to(dtype=dtype, device=device)
        return (*(g if want else None for g, want in zip(live, need)), g_dt, None, None, None)


def birth_death(x, y, k, l, sign, age, lifetime, key, births, dt, *, Lx: float, Ly: float,
                k0: float, k_shape: float, lam: float, x0: float, y0: float):
    """One birth/death step: ``(x, y, k, l, sign, age, lifetime, key,
    births, dead)``. New tensors; the inputs are not modified. Gradients
    reach a live packet's inputs and ``dt`` (``BirthDeath``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"birth/death runs on CPU or CUDA tensors, not {x.device.type}")
    consts = dict(Lx=Lx, Ly=Ly, k0=k0, k_shape=k_shape, lam=lam, x0=x0, y0=y0)
    if not isinstance(dt, torch.Tensor):
        dt = torch.tensor(dt, dtype=x.dtype, device=x.device)
    return BirthDeath.apply(x, y, k, l, sign, age, lifetime, dt, key, births, consts)


def _kernel_fn():
    from ._build import load_library

    fn = load_library().jrsw_birth_death
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn
