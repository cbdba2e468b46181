"""Offline analysis of finished runs (port of ``analysis/``)."""
