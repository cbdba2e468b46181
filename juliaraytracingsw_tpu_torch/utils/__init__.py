"""Experiment helpers (port of ``utils/``)."""
