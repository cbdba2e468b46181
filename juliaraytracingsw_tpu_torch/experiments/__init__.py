"""Runnable experiment entry points (port of ``experiments/``).

``python -m juliaraytracingsw_tpu_torch.experiments <name> [--flag value ...]``
"""
