"""PyTorch + CUDA port of ``juliaraytracingsw_tpu``.

The hero coupled path (f-plane rotating shallow water stepped by IF-AB3,
coupled to WKB packets that interpolate from per-cell patch tables) runs
through :class:`coupled.driver.CoupledDriver`. Module names and layouts
mirror the JAX package, which stays the reference the port is tested
against. The fused RK4 ray substep and the fused DP5(4) attempt are
hand-written CUDA kernels (``csrc/ray_step.cu``, ``csrc/ray_attempt.cu``,
bound in ``ops/ray_step.py``); ``profiling`` runs the gather and copy
probes on four more (``csrc/probe_*.cu``, bound in ``ops/probes.py``);
everything else is plain PyTorch. The entry points run on the card unless
a caller passes ``device="cpu"``.

This package imports ``torch``, ``numpy`` and ``scipy`` only, never JAX.
"""
