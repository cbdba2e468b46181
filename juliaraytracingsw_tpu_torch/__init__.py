"""PyTorch + CUDA port of ``juliaraytracingsw_tpu``.

The hero coupled path (f-plane rotating shallow water stepped by IF-AB3,
coupled to WKB packets that interpolate from per-cell patch tables) runs
through :class:`coupled.driver.CoupledDriver`. Module names and layouts
mirror the JAX package, which stays the reference the port is tested
against. The fused RK4 ray substep is a hand-written CUDA kernel
(``csrc/ray_step.cu``, bound in ``ops/ray_step.py``); everything else is
plain PyTorch.

This package imports ``torch``, ``numpy`` and ``scipy`` only, never JAX.
"""
